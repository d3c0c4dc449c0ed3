"""Runnable user paths of the port: ``quickstart`` (synthetic data -> label
cache -> train -> validate -> predict), ``python3 -m
vision_transformer_cam_tpu_torch.examples.quickstart``."""
