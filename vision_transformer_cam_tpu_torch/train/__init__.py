"""Fine-tuning: optimizer and schedule, train / eval steps, the epoch loop and
checkpoints (the port of vision_transformer_cam_tpu/train)."""
