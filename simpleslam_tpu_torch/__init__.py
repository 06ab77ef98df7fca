"""simpleslam_tpu_torch — the PyTorch + CUDA port of ``simpleslam_tpu``.

Same sub-package layout and module names as the JAX package, so each
function's counterpart is found at the same path:

- ``ops``     — geometry (SE(3), RANSAC, epipolar, triangulation, P3P/PnP,
                Schur-LM bundle adjustment) on tensors, and the hand-written
                CUDA masked-attention kernel (``ops/attention.py`` +
                ``csrc/masked_attention.cu``).
- ``models``  — the learned front-end: ALIKED extractor and LightGlue
                matcher as ``nn.Module``s, plus the JAX-parameter converter.
- ``core``    — map, keyframes, two-view bootstrap, triangulation, BA glue.
- ``run_slam``— ``SLAMSystem``, the per-frame state machine on the host.

Conventions are the reference's: poses are 4x4 ``T_cw`` (camera-from-world,
``x_cam = R @ X_w + t``), quaternions ``xyzw`` with ``w >= 0``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no device given they raise. Importing the package needs only
torch, numpy and the standard library.
"""

__version__ = "0.1.0"
