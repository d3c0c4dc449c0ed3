"""Host data pipeline: VOC12 dataset, transforms and the batch loader."""
