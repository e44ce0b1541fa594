"""Device resolution and the float32 settings the port computes under."""
import torch


def resolve_device(device="cuda"):
    """``torch.device`` for an entry point's ``device`` argument.

    Raises when a CUDA device is asked for and there is none: the port never
    falls back to the CPU on its own. Turns TF32 off for convolutions and
    matrix products, so they run in full float32 as the JAX package computes
    (its whitening and ranking products at ``Precision.HIGHEST``).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


def check_compute_dtype(dtype):
    """Raise on a ``compute_dtype`` the port does not know. float32 runs
    with TF32 off; ``auto``, ``bfloat16`` and ``float16`` resolve in
    ``ops.dtypes.resolve_compute_dtype``."""
    if dtype not in (None, "auto", "float32", "f32", "bfloat16", "float16"):
        raise ValueError("unknown compute_dtype %r (auto, float32, bfloat16 "
                         "or float16)" % (dtype,))
