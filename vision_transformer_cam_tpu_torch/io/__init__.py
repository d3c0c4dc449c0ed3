from vision_transformer_cam_tpu_torch.io import weights  # noqa: F401
