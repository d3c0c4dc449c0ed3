"""Serve CAMs from an exported ``.pt2`` artifact, with no model code (the
port of examples/serve_artifact.py).

The deployment-side counterpart of ``cli.export``: everything this script
imports from the package is host-side glue (JPEG preprocessing and CAM
overlay rendering) and ``kernels.ops``, which registers the ``vitcam::...``
custom ops the artifact calls; the model, its weights, the serving mode and
the int8 calibration are all baked into the artifact:

  # build the artifact once (weights + int8 serving config baked in)
  python -m vision_transformer_cam_tpu_torch.cli.export \\
      --weights ckpt.npz --serving int8 --batch 512 --out model.pt2

  # serve a directory of JPEGs from it
  python -m vision_transformer_cam_tpu_torch.examples.serve_artifact \\
      --artifact model.pt2 --images /path/to/jpegs --out ./served_cams

For every input image it writes ``<name>_cam.jpg`` (JET rollout-CAM
overlay, the reference's utils.py:111-114 blend) and prints the classes of
the top-16-patch head past ``--threshold``.  Images are batched to the
artifact's fixed batch size (the tail is zero-padded and the padding
discarded) and preprocessed as training did (PIL bilinear resize and the
mean / std of the artifact's JSON sidecar).  The artifact runs on the
device its tensors were saved on (the sidecar's platform): an artifact
exported for the card is refused on a host without one.

An artifact exported with ``cli.export --data_parallel`` or ``--seq_parallel
S`` by N ranks (``nr_devices`` N in the sidecar) is served by a process
group of N ranks, one device a rank, as JAX's script rebuilds its mesh of N
devices:

  torchrun --nproc_per_node N -m \
      vision_transformer_cam_tpu_torch.examples.serve_artifact \
      --artifact model.pt2 --images /path/to/jpegs

The script makes the exporter's grid first, in the exporter's order: the
(N / S, S) ('data', 'seq') grid of ``parallel.seq_parallel_mesh(S)`` for a
sequence-sharded artifact, else the ('data',) mesh.  Each rank loads the
program the sidecar names for it (``programs``: one a rank under
``--seq_parallel``) and ``kernels.ops.load_program`` refuses it where the
process groups its collectives name are not the exporter's
(``process_groups``).  Each data rank preprocesses and runs its rows of
every batch (the global batch of the sidecar, cut into N / S blocks; the S
ranks of a data group feed the same rows), the outputs are gathered over
the data group, and rank 0 writes the overlays and prints the classes.  A
group of another size is refused.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--artifact", required=True, help="path to the .pt2 "
                   "program from cli.export (sidecar .json expected next "
                   "to it)")
    p.add_argument("--images", required=True,
                   help="directory of JPEGs, or a glob pattern")
    p.add_argument("--out", default="./served_cams")
    p.add_argument("--threshold", type=float, default=0.9,
                   help="sigmoid threshold for printed class predictions "
                        "(validate.py:133 uses 0.9)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    with open(args.artifact + ".json") as f:
        meta = json.load(f)

    # host-side glue only: no model / weights / config imports
    import numpy as np
    import PIL.Image
    import torch

    from vision_transformer_cam_tpu_torch.cam.render import (_imwrite,
                                                             overlay_cam)
    from vision_transformer_cam_tpu_torch.data.transforms import (
        load_and_preprocess)
    # registers the vitcam custom ops the program calls, and loads it
    from vision_transformer_cam_tpu_torch.kernels import ops
    if not meta.get("with_cam", True):
        raise SystemExit("artifact was exported --no-cam; nothing to render")
    device = torch.device(meta["platforms"][0])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("artifact was exported for the card (platform "
                         "cuda); this host has none (torch.cuda."
                         "is_available() is false)")
    n_dev = meta.get("nr_devices", 1)
    mesh, rank, path, groups = None, 0, args.artifact, None
    if n_dev > 1:
        from vision_transformer_cam_tpu_torch.parallel import mesh as meshlib
        meshlib.distributed_init(device)
        if meshlib.get_world_size() != n_dev:
            raise SystemExit(
                f"artifact was exported for {n_dev} devices: serve it on a "
                f"process group of {n_dev} ranks (torchrun --nproc_per_node "
                f"{n_dev}); this one has {meshlib.get_world_size()}")
        # the exporter's grid, made first: its collectives name the groups
        sp = meta.get("seq_parallel") or 0
        mesh = meshlib.seq_parallel_mesh(sp) if sp else \
            meshlib.make_mesh((-1,), ("data",))
        rank = meshlib.get_rank()
        if "programs" in meta:
            path = os.path.join(os.path.dirname(args.artifact),
                                meta["programs"][rank])
            groups = meta["process_groups"][rank]
    fn = ops.load_program(path, device, groups).module()
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    batch, size = meta["batch"], meta["img_size"]
    data_size, data_rank = (mesh.data_size, mesh.data_rank) if mesh \
        else (1, 0)
    local = batch // data_size
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"artifact: {meta['model_name']} serving={meta['serving']} "
        f"batch={batch} img={size} platforms={meta['platforms']} "
        f"calibration={meta.get('calibration', '?')}"
        + (f" nr_devices={n_dev}" if n_dev > 1 else "")
        + (f" seq_parallel={meta['seq_parallel']}"
           if meta.get("seq_parallel") else ""))

    if os.path.isdir(args.images):
        paths = sorted(p for pat in ("*.jpg", "*.jpeg", "*.JPG", "*.JPEG")
                       for p in glob.glob(os.path.join(args.images, pat)))
    else:
        paths = sorted(glob.glob(args.images))
    if not paths:
        raise SystemExit(f"no images match {args.images}")
    if rank == 0:
        os.makedirs(args.out, exist_ok=True)

    mean = tuple(meta.get("mean", (0.485, 0.456, 0.406)))
    std = tuple(meta.get("std", (0.229, 0.224, 0.225)))
    # a process global no graph records: the precision the program was
    # traced under, restored afterwards
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(meta.get("matmul_precision",
                                                "highest"))
    done = 0
    try:
        for lo in range(0, len(paths), batch):
            chunk = paths[lo:lo + batch]
            # this rank's rows of the batch, the tail padded
            x = np.zeros((local, size, size, 3), np.float32)
            for i, p in enumerate(
                    chunk[data_rank * local:(data_rank + 1) * local]):
                x[i] = load_and_preprocess(p, size, mean, std)
            with torch.no_grad():
                logits, head1_logits, cam = fn(torch.from_numpy(x).to(device))
            if mesh is not None:
                # every data rank's rows, in rank order: the global batch
                head1_logits, cam = (mesh.data_all_gather(t)
                                     for t in (head1_logits, cam))
                if rank:
                    continue
            probs = 1.0 / (1.0 + np.exp(-head1_logits.float().cpu().numpy()
                                        .astype(np.float64)))
            cam = cam.float().cpu().numpy().astype(np.float64)
            for i, p in enumerate(chunk):
                name = os.path.splitext(os.path.basename(p))[0]
                bgr = np.asarray(PIL.Image.open(p).convert("RGB"))[..., ::-1]
                _imwrite(os.path.join(args.out, f"{name}_cam.jpg"),
                         overlay_cam(cam[i], bgr))
                pred = np.nonzero(probs[i] >= args.threshold)[0]
                top = ", ".join(f"{c}:{probs[i][c]:.2f}" for c in pred) \
                    or f"(none >= {args.threshold}; max " \
                       f"{probs[i].argmax()}:{probs[i].max():.2f})"
                print(f"  {name}: {top}")
                done += 1
    finally:
        torch.set_float32_matmul_precision(before)
    say(f"wrote {done} CAM overlays to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
