"""Measurement scripts of the port: ``microbench`` (one stage of the CAM
forward per run), ``attn_variants`` (the attention-kernel ablations) and
``qblock_sweep`` (the attention kernel's query-tile height).  Each is a module
with ``main(argv)``: ``python3 -m vision_transformer_cam_tpu_torch.scripts.<name>``.
"""
