from vision_transformer_cam_tpu_torch.models import (  # noqa: F401
    densenet, resnet, squeezenet)
from vision_transformer_cam_tpu_torch.models.vit import (  # noqa: F401
    ViTCAM, ViTCAMOutput)
