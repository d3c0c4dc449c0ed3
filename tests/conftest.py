"""Test environment: 8 virtual CPU devices (the TPU-world analog of a fake
process group — SURVEY.md §4), x64 enabled so goldens vs the float64 torch
oracle prove exact-math parity."""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"  # env may preset a TPU platform; tests
# need the 8-virtual-device CPU mesh and x64 goldens, neither of which the
# TPU backend supports.
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("MPLBACKEND", "Agg")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# A site-installed PJRT plugin may force its own platform onto
# jax_platforms at interpreter start; the env var alone doesn't win.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (and nvcc for the hand-written "
        "kernels); skips where torch.cuda.is_available() is false")
