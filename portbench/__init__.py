"""The benchmark of the PyTorch and CUDA port (``simpleslam_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once. Everything that belongs to one
configuration, cell or per-layer metric is a file of its own, found by
name: ``configs/<config>.json``, ``workloads/<cell>.json``,
``drivers/<driver>.py``, ``metrics/<metric>.py``. ``flops/`` counts
operations and bytes from shapes; ``reference/`` is the plain float32
reference that decides ``correct``.
"""
