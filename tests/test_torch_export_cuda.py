"""The serving artifact on the card: ``cli.export --check`` of a tiny int8
ViT (head width 64, the CUDA kernels' only one) exported on the GPU, and
one call of the loaded program launching the attention and int8 GEMM
kernels.  This file imports no jax; it runs on a GPU machine as

    python -m pytest --noconftest -m cuda tests/test_torch_export_cuda.py
"""

import pytest
import torch

from vision_transformer_cam_tpu_torch import configs
from vision_transformer_cam_tpu_torch.cli import export as ecli
from vision_transformer_cam_tpu_torch.kernels import attention as ka
from vision_transformer_cam_tpu_torch.kernels import gemm

ZOO = "tinyexportcuda"
DEPTH = 2


def _tiny(num_classes=20, has_logits=False):
    return configs.ViTCAMConfig(img_size=32, patch_size=8, embed_dim=128,
                                depth=DEPTH, num_heads=2,
                                num_classes=num_classes, mask_from=1,
                                top_k_patches=4)


@pytest.mark.cuda
def test_int8_export_check_on_the_card(tmp_path, monkeypatch, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    monkeypatch.setitem(configs.MODEL_ZOO, ZOO, _tiny)
    out = str(tmp_path / "tiny.pt2")
    ka.launches = gemm.linear_int8_launches = 0
    ecli.main(["--model_name", ZOO, "--serving", "int8", "--batch", "4",
               "--out", out, "--check"])
    assert "bit-identical" in capsys.readouterr().out
    # --check runs the artifact and the live function once each
    assert (ka.launches, gemm.linear_int8_launches) == \
        (2 * DEPTH, 2 * (1 + 4 * DEPTH))
    program = torch.export.load(out).module()
    ka.launches = gemm.linear_int8_launches = 0
    logits, head1, cam = program(torch.zeros((4, 32, 32, 3),
                                             device="cuda"))
    torch.cuda.synchronize()
    assert (ka.launches, gemm.linear_int8_launches) == (DEPTH, 1 + 4 * DEPTH)
    assert logits.is_cuda and cam.shape == (4, 4, 4)
    assert torch.isfinite(cam).all() and torch.isfinite(logits.float()).all()
