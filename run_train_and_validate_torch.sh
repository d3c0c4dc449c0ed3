#!/usr/bin/env bash
# The PyTorch/CUDA port's counterpart of run_train_and_validate.sh: the same
# fine-tune and validate, with the same flags, through the port's two CLIs
# (vision_transformer_cam_tpu_torch.cli.train / .validate).  One process
# drives one card; both CLIs run on the card by default.
set -euo pipefail

VOC12_ROOT=${VOC12_ROOT:-/data/VOC2012}
SPLITS=${SPLITS:-./voc12}
WEIGHTS=${WEIGHTS:-}     # pretrained .pth/.npz; empty = random init

python -m vision_transformer_cam_tpu_torch.cli.train \
  --model_name vit_base_patch16_224_in21k \
  --num_classes 20 \
  --epochs 1000 \
  --batch_size 32 \
  --lr 5e-4 \
  --dataset_path "${VOC12_ROOT}" \
  --train_img_name_path "${SPLITS}/train_aug.txt" \
  --val_img_name_path "${SPLITS}/val.txt" \
  --cls_labels_path "${SPLITS}/cls_labels.npy" \
  ${WEIGHTS:+--weights "${WEIGHTS}"} \
  "$@"

python -m vision_transformer_cam_tpu_torch.cli.validate \
  --dataset_path "${VOC12_ROOT}" \
  --val_img_name_path "${SPLITS}/val.txt" \
  --cls_labels_path "${SPLITS}/cls_labels.npy" \
  --batch_size 64
