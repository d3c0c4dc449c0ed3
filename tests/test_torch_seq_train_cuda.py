"""Sequence-parallel training and CAM extraction on the card (``pytest
--noconftest -m cuda tests/test_torch_seq_train_cuda.py``: this file imports
no jax, the machine with the card has none).  Two gloo ranks share the card
on the (1, 2) ('data', 'seq') grid of the dry run.  Skips where there is no
card: the CUDA kernels have no interpret mode."""

import pytest
import torch

from vision_transformer_cam_tpu_torch.scripts import dryrun_multichip


@pytest.mark.cuda
def test_dryrun_multichip_seq_block_on_the_card():
    """The dry run on two ranks sharing the card: its sequence-parallel
    block (N = 17 padded to 18) extracts CAMs on the eager path and on the
    sequence-parallel kernel (one call a block, checked by the dry run) and
    takes one eager step, each against one rank on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no interpret "
                    "mode")
    out = dryrun_multichip.main(["--world", "2"])
    assert out["ok"] and out["transport"].startswith("gloo")
    assert out["sp_loss_dev"] <= dryrun_multichip.TOL["loss"]
    assert out["sp_delta_dev"] <= dryrun_multichip.TOL["delta"][0]
    for impl in ("eager", "kernel"):
        assert out[f"sp_cam_{impl}_dev"] <= dryrun_multichip.TOL["cam"][0]
