"""The device photometric chain over padded uint8 buckets.

The port of the production path of ``mdir_tpu/ops/preprocess.py``:
``chain_from_transform`` lowers a host Compose of the DSL
``pil2np | [apply_clahe[:clip[:space[:grid]]] |
add_clahe_fromrgb[:clip[:grid[:space]]] | tospace:<space>] | totensor |
normalize`` onto the device, and ``make_bucketed_chain`` returns the function
the extractor runs on each chunk's (B, H, W, 3) uint8 bucket, and the train
step on each tuple's bucket (``RawChainInput`` makes the training items raw
uint8).

Only lab is ported, and always exactly: the lab lattice of the ``lab_n``
kernel gives the CLAHE input plane and the a/b channels bit-equal to cv2,
the two CLAHE kernels give the cv2 CLAHE plane (per-image tile geometry from
``clahe.clahe_bucket_aux``), and the float lab -> rgb inverse follows. A chain
in lsh, luv or hls, one that would need the host to ship its L plane, or a
float colorspace conversion after CLAHE raises ``NotImplementedError``
(ROADMAP §1.3); there is no host path in its place. cv2 itself is not on the
card's machine: the CPU tests hold these planes against live cv2.
"""
import numpy as np
import torch

from . import clahe as clahe_ops
from . import colorspace as cs
from . import lab_trilinear

NOT_PORTED = "ROADMAP §1.3"


class DeviceChain:
    """A host transform chain lowered to a device function over u8 buckets.

    ``steps`` are ``(name, args)`` pairs ending in ``("normalize", ())``.
    The CLAHE plane is always computed on the card from the raw RGB
    (``device_l``) through the exact lab lattice (``exact_lab``); the port
    has no path that ships a host-made L plane.
    """

    def __init__(self, steps, mean_std):
        self.steps = steps
        self.mean_std = ([float(m) for m in mean_std[0]],
                         [float(s) for s in mean_std[1]])
        clahe = [args for name, args in steps
                 if name in ("apply_clahe", "add_clahe_fromrgb")]
        if len(clahe) > 1:
            raise ValueError("one CLAHE step per chain")
        for name, args in steps:
            space = {"apply_clahe": 1, "add_clahe_fromrgb": 1,
                     "tospace": 0}.get(name)
            if space is not None and str(args[space]).lower() != "lab":
                raise NotImplementedError(
                    "the device chain is ported for lab only, not %s:%s "
                    "(%s)" % (name, args[space], NOT_PORTED))
        self.exact_lab = any(name != "normalize" for name, _ in steps)
        self.clahe_params = None
        if clahe:
            clip, _, grid = clahe[0]
            self.clahe_params = (float(clip), (int(grid), int(grid)))
        self.device_l = self.clahe_params is not None


def chain_from_transform(transform):
    """Translate a host Compose into a DeviceChain, or None where the JAX
    package keeps the chain on the host (a colorspace step before CLAHE,
    gray, a loose or missing normalize, a step with no device form)."""
    ts = getattr(transform, "transforms", None)
    if not ts:
        return None
    from ..data import transforms as T

    steps = []
    for t in ts:
        if isinstance(t, (T.Pil2Numpy, T.ToTensor)):
            continue
        if isinstance(t, T.Normalize):
            if not t.params["strict_shape"]:
                return None
            steps.append(("normalize", ()))
        elif isinstance(t, T.ApplyClahe):
            if any(n == "tospace" for n, _ in steps):
                # the device CLAHE plane derives from the raw RGB; after a
                # host tospace the host chain derives it from other planes
                return None
            p = t.params  # DSL-parsed params may arrive as strings
            steps.append(("apply_clahe", (float(int(p["clip_limit"])),
                                          str(p["colorspace"]),
                                          int(p["grid_size"]))))
        elif isinstance(t, T.AddClaheFromRgb):
            if any(n == "tospace" for n, _ in steps):
                return None
            p = t.params
            steps.append(("add_clahe_fromrgb", (float(int(p["clip_limit"])),
                                                str(p["colorspace"]),
                                                int(p["grid_size"]))))
        elif isinstance(t, T.ToColorspace):
            if t.params["colorspace"].lower() == "gray":
                return None  # changes the channel count; host path
            steps.append(("tospace", (t.params["colorspace"],)))
        else:
            return None
    if not steps or steps[-1][0] != "normalize" \
            or any(n == "normalize" for n, _ in steps[:-1]):
        return None
    norm = ts[-1]
    if not isinstance(norm, T.Normalize):
        return None
    return DeviceChain(steps[:-1] + [("normalize", ())],
                       (norm.params["mean"], norm.params["std"]))


def make_bucketed_chain(chain):
    """``fn(batch_u8, clahe_aux) -> float32 (B, H, W, C)`` for a DeviceChain.

    ``batch_u8`` is the (B, H, W, 3) uint8 bucket on the device;
    ``clahe_aux`` the device tensors of ``clahe.clahe_bucket_aux`` (None for
    a chain without CLAHE). The output is NHWC and junk outside each image's
    valid extent: the caller masks it.
    """
    def normalize(x):
        mean, std = (torch.tensor(v[:x.shape[-1]], dtype=torch.float32,
                                  device=x.device) for v in chain.mean_std)
        return (x - mean) / std

    def fn(batch_u8, clahe_aux):
        x = batch_u8.to(torch.float32) / 255.0
        raw = True  # x is still batch_u8 / 255: the exact lab path applies
        for name, args in chain.steps:
            if name in ("apply_clahe", "tospace") and not raw:
                raise NotImplementedError(
                    "%s after a colorspace step needs the float rgb -> lab "
                    "conversion (%s)" % (name, NOT_PORTED))
            if name == "apply_clahe":
                _, space, grid = args
                # one lattice launch gives the CLAHE plane and a/b
                l_u8, ab = lab_trilinear.lab_chan(batch_u8)
                chan = clahe_ops.clahe_u8_bucketed(
                    l_u8, clahe_aux, (grid, grid)) / 255.0
                x = cs.normspace2rgb(torch.cat([chan[..., None], ab], -1),
                                     space)
                raw = False
            elif name == "add_clahe_fromrgb":
                _, space, grid = args
                chan = clahe_ops.clahe_u8_bucketed(
                    lab_trilinear.lab_l_u8(batch_u8), clahe_aux,
                    (grid, grid)) / 255.0
                x = torch.cat([x, chan[..., None]], dim=-1)
            elif name == "tospace":
                x = lab_trilinear.lab_normspace(batch_u8)
                raw = False
            elif name == "normalize":
                x = normalize(x)
        return x

    return fn


class RawChainInput:
    """The ``__getitem__``-side stand-in for a host chain lowered to the
    device: training items leave the dataset as raw (H, W, 3) uint8 RGB, and
    ``make_bucketed_chain`` runs the chain on the card inside the train
    step (every ported chain starts from the raw RGB)."""

    def __call__(self, *pics):
        acc = []
        for pic in pics:
            if not isinstance(pic, np.ndarray):
                pic = np.asarray(pic.convert("RGB"), np.uint8)
            elif pic.dtype != np.uint8:
                pic = np.clip(pic * 255.0, 0, 255).astype(np.uint8)
            acc.append(pic)
        return acc[0] if len(acc) == 1 else acc
