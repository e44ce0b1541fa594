"""Compute primitives: pooling (with the GeM+L2N CUDA kernel), resize,
whitening, ranking and mAP."""
