"""Stages over official cirtorch checkpoints -- ``mdir_tpu/stages/
cirtorch_format.py`` (reference ``mdir/stages/cirtorch_format/test.py``) on
the port.

An official checkpoint is a torch file ``{"meta": ..., "state_dict": ...}``
as cirtorch's training writes it. ``embed`` extracts descriptors with such
a net (optionally whitened by a learned pkl from ``whitening_dir``),
``learn_whitening`` learns Lw on a retrieval-SfM whiten database,
``load_whitening`` takes the Lw that a checkpoint's ``meta`` carries, and
``convert_contained_net`` rewrites the checkpoint as a ``CirNetwork``
checkpoint that ``learning.load_network`` reads. Extraction goes through the
batched extractor (``parallel/extract.py``), with uint8 ingress, on
``device`` (the card by default). Nothing is downloaded: a missing file
raises, naming its path.
"""
import math
import os
import pickle
import time

import numpy as np
import torch

from ..data.datasets import cid2filename
from ..device import resolve_device
from ..learning.checkpoints import load_checkpoint_any, save_state
from ..models import initialize_model, torch_import
from ..ops.whitening import whitenapply, whitenlearn
from ..parallel.extract import _decoded, extract_vectors_batched
from ..tools.utils import get_data_root, path_join

WHITENING_NAMES = {"sfm30k": "retrieval-SfM-30k",
                   "sfm120k": "retrieval-SfM-120k"}


def _require_file(path):
    if not os.path.exists(path):
        raise FileNotFoundError("%s does not exist (the port does not "
                                "download)" % path)


def _model_params(meta, pretrained):
    return {
        "architecture": "cirnet",
        "cir_architecture": meta["architecture"],
        "local_whitening": meta.get("local_whitening", False),
        "pooling": meta["pooling"],
        "regional": meta.get("regional", False),
        "whitening": meta["whitening"],
        "pretrained": pretrained,
    }


def _load_official(net_path, device):
    """Official cirtorch checkpoint -> (model on ``device``, meta, state)."""
    _require_file(net_path)
    print(">> Loading network:\n>>>> '{}'".format(net_path))
    state = load_checkpoint_any(net_path)
    meta = state["meta"]
    model = initialize_model(_model_params(meta, False), device=device)
    torch_import.import_model_state(model, state["state_dict"])
    return model, meta, state


def _multiscale(multiscale):
    if not isinstance(multiscale, bool):
        return multiscale
    return [1, 1.0 / math.sqrt(2), 1.0 / 2] if multiscale else [1]


def _extract(model, meta, images, image_size, ms, bbxs=None):
    """(D, N) descriptors of ``images`` (paths, or uint8 HWC arrays taken as
    they are) at scales ``ms``: cirtorch's ``extract_vectors`` with the
    multiscale power p of a GeM net without whitening, else 1."""
    msp = 1.0
    if meta["pooling"] == "gem" and not meta["whitening"]:
        msp = float(model.pool_p)
    arrays = _decoded(images, image_size, bbxs, None, True)
    return extract_vectors_batched(
        model, arrays, scales=ms, msp=msp,
        normalize_mean_std=(meta["mean"], meta["std"]))


def _lw_path(whitening_dir, whitening, image_size, multiscale):
    return os.path.join(whitening_dir, "%s_%s_%s_%s.lw.pkl"
                        % (whitening, None, image_size, multiscale))


def _write_pkl(obj, path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".tmp", "wb") as handle:
        pickle.dump(obj, handle)
    os.replace(path + ".tmp", path)


def embed(params, data, device="cuda"):
    """Descriptors (N, D) of ``data``'s images (and whitened ones with
    ``whitening_dir``) with the official net ``net``."""
    net = params.pop("net")
    imgdir = params.pop("imgdir")
    whitening = params.pop("whitening", None)
    whitening_dir = params.pop("whitening_dir", None)
    image_size = params.pop("image_size", 1024)
    multiscale = params.pop("multiscale", True)
    if params:
        raise ValueError("unknown embed keys: %s" % sorted(params))
    input_images, bbxs = (data[0], None) if len(data) == 1 else data
    impaths = [path_join(imgdir, x) for x in input_images]
    if not data[0]:
        return (({"status": "skipped"}, [], [])
                + (([],) if whitening_dir else tuple()))

    model, meta, _state = _load_official(net, resolve_device(device))
    ms = _multiscale(multiscale)

    lw = None
    if whitening_dir:
        lw_path = _lw_path(whitening_dir, whitening, image_size, multiscale)
        _require_file(lw_path)
        print(">> {}: Loading whitening...".format(whitening))
        with open(lw_path, "rb") as handle:
            lw = pickle.load(handle)

    print(">> Images descriptors...")
    vecs = _extract(model, meta, impaths, image_size, ms, bbxs)

    if lw is not None:
        vecs_lw = whitenapply(*(torch.as_tensor(np.asarray(x, np.float32))
                                for x in (vecs, lw["m"], lw["P"]))).numpy()
        return {}, input_images, vecs.T, vecs_lw.T
    return {}, input_images, vecs.T


def learn_whitening(params, data, device="cuda"):
    """Learn Lw with the official net ``net`` on the whiten database
    ``whitening``; written to ``whitening_dir`` or returned."""
    net = params.pop("net")
    whitening = params.pop("whitening")
    whitening_dir = params.pop("whitening_dir", None)
    image_size = params.pop("image_size", 1024)
    multiscale = params.pop("multiscale", True)
    params.pop("imgdir", None)
    if params or data:
        raise ValueError("learn_whitening takes no data and no keys %s"
                         % sorted(params))
    whitening = WHITENING_NAMES.get(whitening, whitening)

    model, meta, _state = _load_official(net, resolve_device(device))
    ms = _multiscale(multiscale)

    lw, elapsed = _compute_whitening(whitening, model, meta, image_size, ms)

    if whitening_dir:
        _write_pkl(lw, _lw_path(whitening_dir, whitening, image_size,
                                multiscale))
        return ({"whitening_learn": int(elapsed)},)
    return {"whitening_learn": int(elapsed)}, lw


def load_whitening(params, data):
    """The Lw that the official checkpoint ``net`` carries in its meta."""
    net = params.pop("net")
    whitening = params.pop("whitening")
    whitening_dir = params.pop("whitening_dir", None)
    image_size = params.pop("image_size", 1024)
    multiscale = params.pop("multiscale", True)
    params.pop("imgdir", None)
    if params or data:
        raise ValueError("load_whitening takes no data and no keys %s"
                         % sorted(params))
    if not isinstance(multiscale, bool):
        raise ValueError("multiscale is True or False, not %r"
                         % (multiscale,))
    _require_file(net)
    whitening = WHITENING_NAMES.get(whitening, whitening)

    print(">> Loading network:\n>>>> '{}'".format(net))
    state = load_checkpoint_any(net)
    lw = state["meta"]["Lw"][whitening]["ms" if multiscale else "ss"]

    if whitening_dir:
        _write_pkl(lw, _lw_path(whitening_dir, whitening, image_size,
                                multiscale))
        return ({},)
    return {}, lw


def convert_contained_net(params, data):
    """Official cirtorch ``source`` -> the port's CirNetwork checkpoint
    ``net`` (the JAX package's ``network_params``, the weights as a torch
    state dict in cirtorch names). A file conversion: the net is loaded on
    the CPU only to check that every weight has its place."""
    source = params.pop("source")
    net = params.pop("net")
    if params or data:
        raise ValueError("convert_contained_net takes no data and no keys "
                         "%s" % sorted(params))
    _require_file(source)

    print(">> Loading network:\n>>>> '{}'".format(source))
    official = load_checkpoint_any(source)
    meta = dict(official.pop("meta"))

    model_params = _model_params(meta, True)
    for key in ("architecture", "local_whitening", "pooling", "regional",
                "whitening"):
        meta.pop(key, None)
    model = initialize_model(dict(model_params, pretrained=False),
                             device="cpu")
    torch_import.import_model_state(model, official.pop("state_dict"))

    net_state = {
        "type": "CirNetwork",
        "frozen": False,
        "network_params": {
            "model": model_params,
            "runtime": {
                "wrappers": "",
                "data": {
                    "mean_std": [meta.pop("mean"), meta.pop("std")],
                    "transforms": "pil2np | totensor | normalize",
                },
            },
        },
        "model_state": {key: value.detach().clone()
                        for key, value in model.state_dict().items()},
    }

    meta.pop("outputdim", None)
    meta.pop("Lw", None)
    if meta:
        raise ValueError("unknown meta keys in %s: %s"
                         % (source, sorted(meta)))

    if os.path.dirname(net):
        os.makedirs(os.path.dirname(net), exist_ok=True)
    save_state(net_state, net)
    return ({},)


def _compute_whitening(whitening, model, meta, image_size, ms):
    """Lw of ``model`` on ``<data root>/train/<db>/<db>-whiten.pkl``."""
    start = time.time()
    print(">> {}: Learning whitening...".format(whitening))

    db_root = os.path.join(get_data_root(), "train", whitening)
    ims_root = os.path.join(db_root, "ims")
    db_fn = os.path.join(db_root, "{}-whiten.pkl".format(whitening))
    _require_file(db_fn)
    with open(db_fn, "rb") as f:
        db = pickle.load(f)
    images = [cid2filename(cid, ims_root) for cid in db["cids"]]

    print(">> {}: Extracting...".format(whitening))
    wvecs = _extract(model, meta, images, image_size, ms)

    print(">> {}: Learning...".format(whitening))
    m, P = whitenlearn(wvecs, db["qidxs"], db["pidxs"])
    elapsed = time.time() - start
    return {"m": m, "P": P}, elapsed
