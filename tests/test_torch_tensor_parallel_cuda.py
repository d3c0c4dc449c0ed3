"""Tensor parallelism and the pipeline on the card (``pytest --noconftest
-m cuda tests/test_torch_tensor_parallel_cuda.py``: this file imports no
jax, the machine with the card has none).  Two gloo ranks share the card,
each launching kernel 1 and the backward at its own heads.  Skips where
there is no card: the CUDA kernels have no interpret mode."""

import pytest
import torch

from vision_transformer_cam_tpu_torch.scripts import dryrun_multichip


@pytest.mark.cuda
def test_dryrun_multichip_tp_and_pipeline_on_the_card():
    """The dry run on two ranks sharing the card: beside its data-parallel
    blocks, the (1, 2) tensor-parallel step, accumulation, ZeRO-1 and CAM
    extraction on the kernel path (two heads of 64 a rank) and the (1, 2)
    pipeline's forward and step, each against one rank on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no interpret "
                    "mode")
    out = dryrun_multichip.main(["--world", "2"])
    assert out["ok"] and out["tp_zero1_bit_equal"]
    assert out["tp_shape"] == [1, 2] and out["tp_heads"] == [2]
    assert out["pp_blocks"] == [[0, 1, 2], [3, 4, 5]]
    assert out["transport"].startswith("gloo")
