"""The device photometric chain.

The port of ``mdir_tpu/ops/preprocess.py``. Two entry points:

* ``chain_from_transform`` + ``make_bucketed_chain``, the production path:
  a host Compose of the DSL ``pil2np | [apply_clahe[:clip[:space[:grid]]] |
  add_clahe_fromrgb[:clip[:grid[:space]]] | tospace:<space>] | totensor |
  normalize`` lowers onto the device, and the extractor runs the returned
  function on each chunk's (B, H, W, 3) uint8 bucket, the train step on each
  tuple's bucket (``RawChainInput`` keeps the training items raw uint8).
* ``make_device_preprocess``: the same DSL on fixed-size batches, through
  the float conversions, as the JAX package's training-crop chain.

The CLAHE input plane is always computed on the card from the raw RGB, in
each space as the JAX package computes it when its runtime guards pass: lab
through the lattice of the ``lab_n`` kernel (cv2-exact, with the a/b
channels), lsh as ``(max + min) >> 1`` (cv2-exact), luv from the analytic-Y
table (cv2's float Luv plane within one level; ``clahe_plane``). The CLAHE
itself is the two kernels of ``ops/clahe.py`` with per-image tile geometry
from ``clahe.clahe_bucket_aux``. A colorspace step after the first one takes
the float conversions of ``ops/colorspace.py``, as in the JAX package.

The JAX package can instead ship a host-made L plane as a fourth uint8
channel (``DeviceChain.host_input``, ``MDIR_TPU_SHIP_L``), behind cv2 guards
(``spot_check``, ``device_corner_check``, ``float_l_spot_check``). The port
has no such path and no environment switch: cv2 is not on the card's
machine, the CPU tests hold the planes against live cv2, and the card holds
each plane against its CPU computation (``chip_smoke.py``).
"""
import numpy as np
import torch

from . import clahe as clahe_ops
from . import colorspace as cs
from . import lab_trilinear

CLAHE_SPACES = ("lab", "lsh", "luv")
SUPPORTED = {"pil2np", "apply_clahe", "add_clahe_fromrgb", "tospace",
             "totensor", "normalize"}


def _parse_chain(chain):
    steps = []
    for item in [x.strip() for x in chain.split("|") if x.strip()]:
        name, *args = item.split(":")
        steps.append((name, args))
    return steps


def supports_chain(chain):
    """Whether a DSL string is a chain ``make_device_preprocess`` runs."""
    steps = _parse_chain(chain)
    return bool(steps) and all(name in SUPPORTED for name, _ in steps) \
        and steps[-1][0] == "normalize"


def quantize(chan):
    """A [0, 1] float plane -> the host's ``(chan * 255).astype(uint8)``
    as int32 (floor and clip: the same for the values the spaces give)."""
    return torch.clamp(torch.floor(chan * 255.0), 0, 255).to(torch.int32)


def clahe_plane(batch_u8, space):
    """(B, H, W, 3) uint8 RGB -> the (B, H, W) int32 CLAHE input plane of
    ``space``, as the device chain computes it (luv: the analytic-Y L / 100
    cut to uint8 as the host cuts it, JAX ``_float_l_u8``)."""
    space = space.lower()
    if space == "lab":
        return lab_trilinear.lab_l_u8(batch_u8)
    if space == "lsh":
        return lab_trilinear.lsh_l_u8(batch_u8)
    if space == "luv":
        return quantize(cs.rgb_u8_to_luv_l(batch_u8[..., :3]) / 100.0)
    raise cs._unsupported(space)


def _batch_clahe(chan, clip_limit, grid):
    """CLAHE of a (B, H, W) float [0, 1] plane of same-sized images on the
    bucketed kernels (the JAX package's vmapped ``clahe_channel_jax``)."""
    b, h, w = chan.shape
    bh, bw = -(-h // grid[0]) * grid[0], -(-w // grid[1]) * grid[1]
    vals = torch.zeros((b, bh, bw), dtype=torch.int32, device=chan.device)
    vals[:, :h, :w] = quantize(chan)
    aux = clahe_ops.aux_to_device(clahe_ops.clahe_bucket_aux(
        [(h, w)] * b, (bh, bw), clip_limit, grid), chan.device)
    out = clahe_ops.clahe_u8_bucketed(vals, aux, grid)
    return out[:, :h, :w] / 255.0


def make_device_preprocess(chain, mean_std):
    """``fn(batch_u8) -> float32 (N, H, W, C)`` for a DSL string on a
    (N, H, W, 3) uint8 batch of one size, through the float conversions."""
    if not supports_chain(chain):
        raise ValueError("not a device chain: %r" % chain)
    steps = _parse_chain(chain)

    def clahe_args(name, args):
        clip = float(int(float(args[0]))) if args else 4.0
        if name == "apply_clahe":
            space = args[1] if len(args) > 1 else "lab"
            grid = (int(args[2]),) * 2 if len(args) > 2 else (8, 8)
        else:
            grid = (int(args[1]),) * 2 if len(args) > 1 else (8, 8)
            space = args[2] if len(args) > 2 else "lab"
        return clip, space, grid

    @torch.no_grad()
    def fn(batch_u8):
        x = batch_u8.to(torch.float32) / 255.0
        for name, args in steps:
            if name in ("apply_clahe", "add_clahe_fromrgb"):
                clip, space, grid = clahe_args(name, args)
                spc = cs.rgb2normspace(x[..., :3], space)
                chan = _batch_clahe(spc[..., 0], clip, grid)
                if name == "apply_clahe":
                    x = cs.normspace2rgb(
                        torch.cat([chan[..., None], spc[..., 1:]], -1), space)
                else:
                    x = torch.cat([x, chan[..., None]], dim=-1)
            elif name == "tospace":
                x = cs.rgb2normspace(x[..., :3], args[0])
            elif name == "normalize":
                mean, std = (torch.tensor(v[:x.shape[-1]], dtype=torch.float32,
                                          device=x.device) for v in mean_std)
                x = (x - mean) / std
        return x

    return fn


class DeviceChain:
    """A host transform chain lowered to a device function over u8 buckets.

    ``steps`` are ``(name, args)`` pairs ending in ``("normalize", ())``.
    The CLAHE plane is computed on the card from the raw RGB
    (``device_l``, always); ``exact_lab`` (a step touches lab) takes the
    lab planes from the ``lab_n`` lattice. A CLAHE space other than lab,
    lsh and luv raises, as the JAX package's host conversion does.
    """

    def __init__(self, steps, mean_std):
        self.steps = steps
        self.mean_std = ([float(m) for m in mean_std[0]],
                         [float(s) for s in mean_std[1]])
        clahe = [args for name, args in steps
                 if name in ("apply_clahe", "add_clahe_fromrgb")]
        if len(clahe) > 1:
            raise ValueError("one CLAHE step per chain")
        self.exact_lab = any(
            (name in ("apply_clahe", "add_clahe_fromrgb")
             and args[1] == "lab")
            or (name == "tospace" and args[0].lower() == "lab")
            for name, args in steps)
        for name, args in steps:
            if name == "tospace" and args[0].lower() not in cs.NORMSPACES:
                raise cs._unsupported(args[0])
        self.clahe_params = None
        self.clahe_space = None
        if clahe:
            clip, space, grid = clahe[0]
            if space.lower() not in CLAHE_SPACES:
                raise cs._unsupported(space)
            self.clahe_params = (float(clip), (int(grid), int(grid)))
            self.clahe_space = space
        self.device_l = self.clahe_params is not None


def chain_from_transform(transform):
    """Translate a host Compose into a DeviceChain, or None where the JAX
    package keeps the chain on the host (a colorspace step before CLAHE,
    gray, a loose or missing normalize, ``create_clahed``, a step with no
    device form)."""
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
        elif isinstance(t, T.ApplyClahe) \
                and not isinstance(t, T.CreateClahedImage):
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
    exact_lab = chain.exact_lab

    def normalize(x):
        mean, std = (torch.tensor(v[:x.shape[-1]], dtype=torch.float32,
                                  device=x.device) for v in chain.mean_std)
        return (x - mean) / std

    def clahe_chan(batch_u8, aux, grid):
        plane = clahe_plane(batch_u8, chain.clahe_space)
        return clahe_ops.clahe_u8_bucketed(plane, aux, (grid, grid)) / 255.0

    def fn(batch_u8, clahe_aux):
        x = batch_u8.to(torch.float32) / 255.0
        raw = True  # x is still batch_u8 / 255: the uint8 paths apply
        for name, args in chain.steps:
            if name == "apply_clahe":
                _, space, grid = args
                if raw and exact_lab and space == "lab":
                    # one lattice launch gives the CLAHE plane and a/b
                    l_u8, ab = lab_trilinear.lab_chan(batch_u8)
                    chan = clahe_ops.clahe_u8_bucketed(
                        l_u8, clahe_aux, (grid, grid)) / 255.0
                    spc = torch.cat([chan[..., None], ab], dim=-1)
                else:
                    chan = clahe_chan(batch_u8, clahe_aux, grid)
                    spc = cs.rgb_u8_to_normspace(batch_u8, space) if raw \
                        else cs.rgb2normspace(x[..., :3], space)
                    spc = torch.cat([chan[..., None], spc[..., 1:]], dim=-1)
                x = cs.normspace2rgb(spc, space)
                raw = False
            elif name == "add_clahe_fromrgb":
                _, space, grid = args
                chan = clahe_chan(batch_u8, clahe_aux, grid)
                x = torch.cat([x, chan[..., None]], dim=-1)
            elif name == "tospace":
                space = args[0]
                if raw and exact_lab and space.lower() == "lab":
                    x = lab_trilinear.lab_normspace(batch_u8)
                elif raw:
                    x = cs.rgb_u8_to_normspace(batch_u8, space)
                else:
                    x = cs.rgb2normspace(x[..., :3], space)
                raw = False
            elif name == "normalize":
                x = normalize(x)
        return x

    return fn


class RawChainInput:
    """The ``__getitem__``-side stand-in for a host chain lowered to the
    device: training items leave the dataset as raw (H, W, 3) uint8 RGB, and
    ``make_bucketed_chain`` runs the chain on the card inside the train
    step (every lowered chain starts from the raw RGB)."""

    def __call__(self, *pics):
        acc = []
        for pic in pics:
            if not isinstance(pic, np.ndarray):
                pic = np.asarray(pic.convert("RGB"), np.uint8)
            elif pic.dtype != np.uint8:
                pic = np.clip(pic * 255.0, 0, 255).astype(np.uint8)
            acc.append(pic)
        return acc[0] if len(acc) == 1 else acc
