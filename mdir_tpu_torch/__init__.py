"""mdir_tpu_torch: the PyTorch/CUDA port of mdir_tpu for NVIDIA Hopper.

The package mirrors ``mdir_tpu``'s layout. Plain tensor code is PyTorch in
NCHW/OIHW layout; each Pallas TPU kernel of the JAX package becomes a CUDA
kernel written for sm_90a (``csrc/``, built by ``_build.py``) with a plain
PyTorch version beside it. Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``; without a card they raise.

Importing the package imports only torch, numpy, scipy and the standard
library. It never imports JAX or ``mdir_tpu``, and nothing in it downloads.
"""
__version__ = "0.1.0"
