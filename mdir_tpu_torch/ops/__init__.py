"""Compute primitives: pooling (with the GeM+L2N CUDA kernel), resize,
whitening, ranking and mAP, and the lab CLAHE device chain (the lab lattice
and CLAHE CUDA kernels, lab -> rgb, the chain itself)."""
