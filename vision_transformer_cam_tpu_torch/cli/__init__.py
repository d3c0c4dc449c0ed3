"""Command-line entry points of the port, mirroring the reference's scripts
(each takes ``--device``: the card by default, ``cpu`` on request):

  python -m vision_transformer_cam_tpu_torch.cli.train     (fine-tune)
  python -m vision_transformer_cam_tpu_torch.cli.validate  (mAP, pseudo-seg
                                                            PNGs, mIoU,
                                                            rollout overlays)
  python -m vision_transformer_cam_tpu_torch.cli.predict   (one image's CAM
                                                            grid)
  python -m vision_transformer_cam_tpu_torch.cli.export    (the serving
                                                            artifact, .pt2)
  python -m vision_transformer_cam_tpu_torch.cli.tools     (make_cls_labels /
                                                            make_splits /
                                                            make_class_indices
                                                            / get_palette /
                                                            flops / convert /
                                                            convert_sbd; host
                                                            only, no --device)
  python -m vision_transformer_cam_tpu_torch.cli.cnn_cam_demo
                                                           (the classic
                                                            CNN-CAM demo:
                                                            resnet18,
                                                            squeezenet1_1,
                                                            densenet161)
"""
