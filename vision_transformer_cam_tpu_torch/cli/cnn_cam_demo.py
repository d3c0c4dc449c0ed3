"""Classic CNN-CAM demo (t.py:1-130 parity), for PyTorch (the port of
vision_transformer_cam_tpu/cli/cnn_cam_demo.py).

The reference hooks the last conv block of a torchvision CNN
(squeezenet1_1, model_id 1; resnet18, 2; densenet161, 3; t.py:25-33), dots
the feature maps with the classifier weights of the top-5 softmax classes and
writes JET-overlay jpgs.  Same flow here with the port's CNNs (``--arch``
selects among models/{resnet,squeezenet,densenet}.py, each of which returns
the hooked feature tensor beside the logits).  ``--weights`` reads a CNN
pytree in the flat ``.npz`` layout with list positions as path parts
(``io.weights.save_cnn_npz``); without it the weights are drawn from a seed,
which demonstrates the pipeline.  ``--device``: the card by default, the CPU
on request.  On the card the forward runs with TF32 off (cuDNN and the
matmuls), so that its float32 CAMs are the CPU's to rounding.

    python -m vision_transformer_cam_tpu_torch.cli.cnn_cam_demo \\
        --image IMG.jpg --arch resnet18 [--weights W.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from vision_transformer_cam_tpu_torch.cam.render import _imwrite, overlay_cam
from vision_transformer_cam_tpu_torch.data.transforms import preprocess_array
from vision_transformer_cam_tpu_torch.models import (densenet, resnet,
                                                     squeezenet)
from vision_transformer_cam_tpu_torch.utils import resolve_device

# t.py:25-33's model_id table, keyed by the torchvision factory names: the
# module and its class
ARCHS = {"resnet18": (resnet, resnet.ResNet),
         "squeezenet1_1": (squeezenet, squeezenet.SqueezeNet),
         "densenet161": (densenet, densenet.DenseNet)}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", type=str, required=True)
    p.add_argument("--arch", type=str, default="resnet18",
                   choices=sorted(ARCHS),
                   help="CNN architecture (t.py:25-33's model_id table)")
    p.add_argument("--weights", type=str, default="",
                   help=".npz CNN pytree (list positions as path parts); "
                        "empty = seeded random init")
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--labels_json", type=str, default="",
                   help="JSON array of class names (the reference's "
                        "imagenet-simple-labels.json, t.py:19,95-104); "
                        "empty = print bare class indices")
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--out", type=str, default="./cnn_cam")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def build_model(arch: str, weights: str = "", num_classes: int = 1000,
                device=None):
    """The ``--arch`` CNN on ``device``: the ``--weights`` archive's
    weights, or drawn from ``torch.Generator().manual_seed(0)``."""
    module, cls = ARCHS[arch]
    if weights:
        from vision_transformer_cam_tpu_torch.io.weights import load_cnn_npz
        return module.from_jax(load_cnn_npz(weights), device=device,
                               dtype=torch.float32)
    return cls(num_classes, device=device,
               generator=torch.Generator().manual_seed(0))


@contextlib.contextmanager
def no_tf32():
    """TF32 off in cuDNN convolutions and matmuls within the block, the
    earlier settings restored after it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    model = build_model(args.arch, args.weights, args.num_classes, device)

    import PIL.Image
    pil = PIL.Image.open(args.image).convert("RGB")
    img_bgr = np.asarray(pil)[..., ::-1]
    x = preprocess_array(np.asarray(pil), 224, (0.485, 0.456, 0.406),
                         (0.229, 0.224, 0.225))
    with torch.no_grad(), no_tf32():
        logits, feats = model(torch.from_numpy(x[None]).to(device))
    probs = torch.softmax(logits[0], dim=-1).cpu().numpy()
    top = np.argsort(-probs)[:args.topk]
    names = None
    if args.labels_json:
        import json
        with open(args.labels_json) as f:
            names = json.load(f)
        for c in top:  # '{prob:.3f} -> {name}' lines (t.py:102-104)
            print(f"{probs[c]:.3f} -> {names[int(c)]}")
    else:
        print("top classes:", [(int(c), float(probs[c])) for c in top])

    module = ARCHS[args.arch][0]
    cams = resnet.return_cam(feats[0].cpu().numpy(),
                             module.cam_weight(model), top)
    name = os.path.splitext(os.path.basename(args.image))[0]
    for rank, (c, cam) in enumerate(zip(top, cams)):
        path = os.path.join(args.out, f"{name}_cam_top{rank}_cls{int(c)}.jpg")
        _imwrite(path, overlay_cam(cam, img_bgr))
        print("saved", path)
    return {"top": top, "probs": probs, "cams": cams, "names": names}


if __name__ == "__main__":
    main()
