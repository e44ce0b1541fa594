"""Network eval wrappers: multi-scale aggregation and learned whitening.

The semantics of ``mdir_tpu/learning/wrappers.py`` (reference
``mdir/components/data/wrapper.py``): Compose runs each wrapper's
preprocess in order, the inference, then the postprocesses in reverse. The
string DSL (``"cirmultiscale:True,fakebatch"``) and N_-prefixed ordered
dicts are kept. On the per-image path a tensor is one (1, C, H, W) image or
a (D,) descriptor. The batched extractor (``parallel/extract.py``) computes
what these wrappers compute, in one pass per shape bucket.
"""
import pickle

import numpy as np
import torch

from ..ops.resize import resize_bilinear
from ..ops.whitening import whitenapply


class Compose:
    """Apply wrappers' preprocess forward, inference, postprocess backward."""

    def __init__(self, wrappers):
        self.wrappers = wrappers

    def __call__(self, tensor, inference, model=None):
        if not self.wrappers:
            return inference(tensor)
        if model is None:
            model = inference
        metadata = []
        for wrapper in self.wrappers:
            tensor, meta = wrapper.preprocess(tensor, model)
            metadata.append(meta)
        if isinstance(tensor, list):
            tensor = [inference(x) for x in tensor]
        else:
            tensor = inference(tensor)
        for wrapper, meta in reversed(list(zip(self.wrappers, metadata))):
            tensor = wrapper.postprocess(tensor, model, meta)
        return tensor


class Wrapper:

    def preprocess(self, tensor, _model):
        return tensor, None

    def postprocess(self, tensor, _model, _metadata):
        return tensor


class CirMultiscaleAggregation(Wrapper):
    """Multi-scale descriptors with p-power mean aggregation.

    scales True -> [1, 1/sqrt(2), 1/2]; the aggregation power msp is GeM's p
    when the model is GeM, not regional and not whitened, else 1.
    """

    def __init__(self, scales):
        if isinstance(scales, str):
            scales = {"True": True, "False": False}[scales]
        if isinstance(scales, bool):
            scales = [1, 1.0 / np.sqrt(2), 1.0 / 2] if scales else [1]
        self.scales = scales

    def preprocess(self, tensor, _model):
        if len(self.scales) == 1:
            return (tensor if isinstance(tensor, list) else [tensor],
                    isinstance(tensor, list))

        def scaled(single):
            return [single if s == 1 else resize_bilinear(single, s)
                    for s in self.scales]

        if isinstance(tensor, list):
            acc = []
            for single in tensor:
                acc.extend(scaled(single))
            return acc, True
        return scaled(tensor), False

    @staticmethod
    def aggregate_tensor(tensors, nscales, msp):
        assert len(tensors) == nscales, "%s != %s" % (len(tensors), nscales)
        v = sum(sub.reshape(-1) ** msp for sub in tensors)
        v = (v / nscales) ** (1.0 / msp)
        return v / torch.linalg.vector_norm(v)

    @staticmethod
    def msp(model, nscales):
        meta = model.meta
        if nscales > 1 and meta["pooling"] == "gem" and not meta["regional"] \
                and not meta["whitening"]:
            return model.pool_p
        return 1.0

    def postprocess(self, tensor, model, waslist):
        n = len(self.scales)
        msp = self.msp(model, n)
        if not waslist:
            return self.aggregate_tensor(tensor, n, msp)
        assert len(tensor) % n == 0
        return [self.aggregate_tensor(tensor[i:i + n], n, msp)
                for i in range(0, len(tensor), n)]


class FakeBatch(Wrapper):
    """List of per-image descriptor vectors -> (D, N) matrix."""

    def postprocess(self, tensor, model, _meta):
        if not isinstance(tensor, list):
            return tensor
        return torch.stack([v.reshape(-1) for v in tensor], dim=1)


class CirtorchWhiten(Wrapper):
    """Learned whitening P[:dims] (x - m) + L2, parameters from a pkl."""

    def __init__(self, whitening, dimensions=None):
        with open(whitening, "rb") as handle:
            whit = pickle.load(handle)
        self.P = torch.from_numpy(np.asarray(whit["P"], np.float32))
        self.m = torch.from_numpy(np.asarray(whit["m"], np.float32))
        self.dimensions = int(dimensions) if dimensions \
            else self.P.shape[0]

    def postprocess(self, tensor, model, _meta):
        x = tensor[:, None] if tensor.dim() == 1 else tensor
        proj = whitenapply(x, self.m.to(x.device), self.P.to(x.device),
                           self.dimensions)
        return proj[:, 0] if tensor.dim() == 1 else proj


WRAPPERS_LABELS = {
    "cirmultiscale": CirMultiscaleAggregation,
    "fakebatch": FakeBatch,
    # The train wrapper spec of the CirNetwork scenarios: the train step runs
    # tuples itself (learning/train_step.py), so on the per-image path this
    # is the plain fakebatch.
    "cirfaketuplebatch": FakeBatch,
    "cirwhiten": CirtorchWhiten,
}


def initialize_wrappers(net_wrappers):
    """String DSL or N_-prefixed dict -> Compose."""
    if net_wrappers is None:
        wraps = []
    elif isinstance(net_wrappers, str):
        wraps = []
        for wrap in [x for x in net_wrappers.split(",") if x]:
            wname, *args = wrap.split(":", 1)
            args = args[0].split(",") if args else []
            wraps.append(WRAPPERS_LABELS[wname](*args))
    else:
        wraps = [WRAPPERS_LABELS[x.split("_", 1)[1]](**net_wrappers[x])
                 for x in sorted(net_wrappers)]
    return Compose(wraps)
