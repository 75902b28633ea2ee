"""Training (port of pose6d_tpu/train: loss, augmentation, step,
checkpoints, logging, the train-IR metric and the train() loop)."""
