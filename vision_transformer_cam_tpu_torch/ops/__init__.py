from vision_transformer_cam_tpu_torch.ops import rollout  # noqa: F401
