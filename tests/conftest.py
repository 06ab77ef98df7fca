"""Test configuration: force a virtual 8-device CPU mesh before any test runs.

Mirrors the reference's headless-GUI forcing trick
(reference: tests/test_track_with_pnp.py:9-16) and adds the TPU build's
multi-chip CPU harness (SURVEY.md §4: "CPU-backend jax.device_count()-based
harness for sharded extraction/matching").

Note: this machine's site customization registers an experimental TPU
platform and pins ``jax_platforms`` via jax.config at interpreter startup, so
an env-var-only override is not enough — we must update jax.config after
import as well.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("QT_QPA_PLATFORM", "offscreen")
os.environ.setdefault("MPLBACKEND", "Agg")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import matplotlib  # noqa: E402

matplotlib.use("Agg", force=True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
