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
    """The port computes in float32 with TF32 off. ``auto`` means float32
    until the bfloat16 policy and its first-chunk guard are ported (ROADMAP
    §1.2), where the JAX package picks bfloat16 on an accelerator."""
    if dtype == "bfloat16":
        raise NotImplementedError(
            "bfloat16 compute and its guard are not ported yet (ROADMAP "
            "§1.2); use compute_dtype float32 or auto")
    if dtype not in (None, "auto", "float32"):
        raise ValueError("unknown compute_dtype %r" % (dtype,))
