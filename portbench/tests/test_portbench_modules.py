"""The check for JAX modules compares whole top-level names."""
import sys
import types

import portbench_tiny as tiny
from portbench import harness


def test_top_level_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["simpleslam_tpu_torch", "simpleslam_tpu_torch.models", "numpy",
         "jaxtyping", "flaxen.x"]) == []
    assert harness.forbidden_modules(
        ["simpleslam_tpu", "simpleslam_tpu.ops.se3", "jax.numpy",
         "jaxlib.xla_client", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "simpleslam_tpu"]


def test_a_run_that_loaded_the_jax_package_prints_no_result(tmp_path,
                                                            monkeypatch):
    f = tiny.files(tmp_path)
    monkeypatch.setitem(sys.modules, "simpleslam_tpu",
                        types.ModuleType("simpleslam_tpu"))
    rc, line = tiny.run_cell(f, "tiny.pairs")
    assert rc != 0 and line is None


def test_a_run_without_a_card_prints_no_result(tmp_path):
    import io
    import torch
    from portbench import run
    if torch.cuda.is_available():
        return
    buf = io.StringIO()
    rc = run.main(["--workload", "lightglue-kitti-2048.pairs-b32", "--seed",
                   "1", "--seconds", "1"], out=buf)
    assert rc != 0 and buf.getvalue() == ""
