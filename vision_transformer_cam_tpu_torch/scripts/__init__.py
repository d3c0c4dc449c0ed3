"""Measurement scripts of the port: ``microbench`` (one stage of the CAM
forward per run), ``attn_variants`` (the attention-kernel ablations),
``qblock_sweep`` (the attention kernel's query-tile height), and the quality
protocol on trained weights: ``quality_eval`` (fine-tune on synthetic data,
every serving mode against float32), ``seg_diagnose`` (the pseudo-seg chain
stage by stage) and ``precision_ladder`` (float32 GEMM precisions against
CPU references).  Each is a module with ``main(argv)``:
``python3 -m vision_transformer_cam_tpu_torch.scripts.<name>``.
"""
