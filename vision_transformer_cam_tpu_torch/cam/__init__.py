"""CAM / pseudo-segmentation subsystem (the port of
vision_transformer_cam_tpu/cam):
  * pseudo_seg: the reference validate's per-image pipeline, batched on
    tensors up to the resolution-independent math, numpy for the per-image
    upsampling;
  * render: CAM heatmap overlays.
"""

from vision_transformer_cam_tpu_torch.cam.pseudo_seg import (  # noqa: F401
    PseudoSegDeviceOut, compose_pseudo_seg, pseudo_seg_batch,
    pseudo_seg_device)
from vision_transformer_cam_tpu_torch.cam.render import (  # noqa: F401
    cam_norm, jet_colormap, overlay_cam, render_origin_cams)
