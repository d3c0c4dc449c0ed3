"""The port's resize ops and pos-embed interpolation against the JAX
package's (jax.image.resize), on seeded inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_transformer_cam_tpu import configs as jcfgs
from vision_transformer_cam_tpu.io import weights as jwio
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu.ops import interpolate as jint
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch.io import weights as twio
from vision_transformer_cam_tpu_torch.models import vit as tvit
from vision_transformer_cam_tpu_torch.ops import interpolate as tint


@pytest.mark.parametrize("size", [(40, 52), (14, 14), (7, 9), (30, 11)])
def test_bilinear_resize_matches_jax(size):
    # cosine maps and rollout rows, what the port resizes, lie in [-1, 1]
    x = np.random.default_rng(0).uniform(-1, 1, (2, 3, 14, 14)).astype(
        np.float32)
    got = tint.bilinear_resize(torch.from_numpy(x), size).numpy()
    want = np.asarray(jint.bilinear_resize(jnp.asarray(x), size))
    assert got.shape == want.shape == (2, 3) + size
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_bilinear_upsampling_is_torch_interpolate():
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (1, 2, 6, 5))).float()
    want = torch.nn.functional.interpolate(x, size=(17, 23), mode="bilinear",
                                           align_corners=False)
    np.testing.assert_allclose(tint.bilinear_resize(x, (17, 23)).numpy(),
                               want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [(40, 52), (5, 3), (14, 14)])
def test_nearest_resize_matches_jax_exactly(size):
    x = np.random.default_rng(2).integers(0, 21, size=(3, 14, 14)).astype(
        np.int32)
    got = tint.nearest_resize(torch.from_numpy(x), size).numpy()
    want = np.asarray(jint.nearest_resize(jnp.asarray(x), size))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("old,new,tokens", [(14, 24, 1), (14, 32, 1),
                                            (14, 24, 2), (14, 7, 1)])
def test_interpolate_pos_embed_matches_jax_bicubic(old, new, tokens):
    """Keys a = -0.5 with the edge renormalisation of jax.image.resize (not
    F.interpolate's a = -0.75 with a repeated border); 14 -> 7 also takes
    its antialiasing."""
    pe = np.random.default_rng(3).standard_normal(
        (1, tokens + old * old, 48)).astype(np.float32)
    got = tint.interpolate_pos_embed(torch.from_numpy(pe), old, new,
                                     num_tokens=tokens).numpy()
    want = np.asarray(jint.interpolate_pos_embed(jnp.asarray(pe), old, new,
                                                 num_tokens=tokens))
    assert got.shape == want.shape == (1, tokens + new * new, 48)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[:, :tokens], pe[:, :tokens])
    if new > old:
        torch_bicubic = torch.nn.functional.interpolate(
            torch.from_numpy(pe[:, tokens:]).reshape(1, old, old, 48)
            .permute(0, 3, 1, 2), size=(new, new), mode="bicubic",
            align_corners=False).permute(0, 2, 3, 1).reshape(1, -1, 48)
        # the library call is another function: it must not be what we use
        assert np.abs(torch_bicubic.numpy() - want[:, tokens:]).max() > 1e-2


def test_checkpoint_of_another_resolution_loads_like_jax(tmp_path):
    """A 32-pixel (4x4 grid) state dict loaded into a 56-pixel (7x7) model
    equals the JAX package's load of the same file."""
    size = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2,
                num_classes=5, top_k_patches=4)
    small = jcfgs.ViTCAMConfig(img_size=32, **size)
    params = jvit.init(small, jax.random.key(0))
    sd = jwio.state_dict_from_pytree(params, small)
    path = str(tmp_path / "small.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               path)
    want = jwio.load_weights(path, jcfgs.ViTCAMConfig(img_size=56, **size))
    model = tvit.ViTCAM(tcfgs.ViTCAMConfig(img_size=56, **size), device="cpu")
    twio.load_weights(path, model)
    assert model.pos_embed.shape == (1, 50, 32)
    np.testing.assert_allclose(model.pos_embed.detach().numpy(),
                               np.asarray(want["pos_embed"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(model.cls_token.detach().numpy(),
                                  np.asarray(want["cls_token"]))
    x = np.random.default_rng(4).standard_normal((2, 56, 56, 3)).astype(
        np.float32)
    got = model(torch.from_numpy(x))
    ref = jvit.apply(want, jnp.asarray(x),
                     jcfgs.ViTCAMConfig(img_size=56, **size))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits),
                               rtol=0, atol=1e-5)
