"""Data parallelism on the card (``pytest --noconftest -m cuda
tests/test_torch_data_parallel_cuda.py``: this file imports no jax, the
machine with the card has none).  Two gloo ranks share the card, each
launching the kernels one device launches.  Skips where there is no card:
the CUDA kernels have no interpret mode."""

import pytest
import torch

from vision_transformer_cam_tpu_torch.scripts import dryrun_multichip


@pytest.mark.cuda
def test_dryrun_multichip_on_the_card():
    """The dry run's four blocks (DP step, accumulation, ZeRO-1 bit for
    bit, batch-sharded CAM extraction) on two ranks sharing the card, each
    against one rank on the card, through the kernel path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no interpret "
                    "mode")
    out = dryrun_multichip.main(["--world", "2"])
    assert out["ok"] and out["zero1_bit_equal"]
    assert out["transport"].startswith("gloo")
