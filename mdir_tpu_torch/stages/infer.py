"""infer stage: descriptor dumps and dataset translation --
``mdir_tpu/stages/infer.py`` (reference ``mdir/stages/infer.py``) on the
port.

``infer(params, data) -> (metadata, *output.postprocess())``. With nothing
left to do (an ``append`` output that finds every file) it returns
``{"status": "skipped"}`` before loading the network; otherwise the
metadata holds ``stats`` and ``resource_usage``. A ``CirImageList`` dataset
takes a batched route:

* an ``embedding`` output of a descriptor network goes through
  ``parallel/extract.py::extract_vectors_network`` (the composed extractor
  for a 2-net composition, else the single-net ``StreamingExtractor``: the
  GeM+L2N kernel, and the device lab CLAHE chain on a CLAHE transform). A
  missing image under ``ignore_errors`` is a NaN row;
* an ``rgb`` output of a translator goes through
  ``parallel/translate.py::StreamingTranslator``.

Anything else runs the per-item loader loop. A transform that does not
lower to the device chain (a photometric step before a translator, a
colorspace step before CLAHE) runs on the host, its device transforms
(``data.transforms.on_device``) on the network's device, on every route.
The dataset's ``loader`` (default ``data.images.pil_loader``) decodes the
images on both batched routes. The JAX package sends a dataset with its own
``loader`` down the per-item loop; the port keeps it on the batched route,
which gives the same rows.
"""
import copy

import numpy as np
import torch

from ..data.datasets import initialize_dataset_loader
from ..data.images import ImagesFromList, pil_loader
from ..data.outputs import EmbeddingOutput, RgbImageSaver, initialize_output
from ..data.transforms import initialize_transforms, on_device
from ..learning import load_network
from ..parallel.extract import (_composable, _plain_normalize_chain,
                                extract_vectors_network)
from ..parallel.translate import StreamingTranslator, _translator_divisor
from ..tools import stats
from ..tools.utils import get_dataset_params, path_join


def infer(params, data, device="cuda"):
    """Run the scenario's network over ``data`` on ``device`` (the card by
    default) into its ``output: inference``."""
    np.random.seed(0)

    if not data[0]:
        # append-mode fast path: probe the output before loading the network
        probe = initialize_output(
            copy.deepcopy(params["output"]["inference"]),
            get_dataset_params(params["data"]["test"], {}), data)
        if not probe.preprocess()[0]:
            return ({"status": "skipped"},) + probe.postprocess()

    network = load_network(params["network"], device=device).eval()
    data_params = get_dataset_params(
        params["data"]["test"],
        network.network_params.runtime.get("data") or {})

    output = initialize_output(copy.deepcopy(params["output"]["inference"]),
                               copy.deepcopy(data_params), data)
    remaining = output.preprocess()
    if not remaining[0]:
        return ({"status": "skipped"},) + output.postprocess()

    meter = stats.AverageMeter("Infer", len(remaining[0]),
                               debug=params["output"].get("debug", False))
    resources = stats.ResourceUsage()

    done = _run_batched(network, output, remaining,
                        copy.deepcopy(data_params), meter)
    if done is None:
        _run_per_item(network, output, remaining,
                      copy.deepcopy(data_params), meter)
    resources.take_current_stats()

    metadata = {"stats": meter.total_stats(),
                "resource_usage": resources.get_resources()}
    return (metadata,) + output.postprocess()


def _run_batched(network, output, remaining, data_params, meter):
    """Run a batched route; None when the scenario has none."""
    dataset = dict(data_params.get("dataset", {}))
    if dataset.pop("name", None) != "CirImageList":
        return None
    if isinstance(output, EmbeddingOutput):
        return _run_embedding(network, output, remaining, data_params,
                              dataset, meter)
    if isinstance(output, RgbImageSaver):
        return _run_translation(network, output, remaining, data_params,
                                dataset, meter)
    return None


def _run_embedding(network, output, remaining, data_params, dataset, meter):
    # descriptor networks only: an image -> image model under an embedding
    # output (flattened pixels as descriptors) keeps the per-item path
    model = getattr(network, "model", None)
    if not (_composable(network) or (not hasattr(network, "sequence")
                                     and "pooling" in model.meta)):
        return None

    images, bbxs = (remaining + (None,))[:2]
    image_dir = dataset.pop("image_dir")
    image_size = dataset.pop("image_size", None)
    ignore_errors = dataset.pop("ignore_errors", False)
    loader = dataset.pop("loader", pil_loader)
    if dataset:  # unknown dataset keys -> the per-item path
        return None

    paths = [path_join(image_dir, name) for name in images]
    good = list(range(len(paths)))
    if ignore_errors:
        # the loader's failure is the dataset's `{}` sentinel: a NaN row
        good = [i for i in good
                if not isinstance(loader(paths[i]), Exception)]
        for i in sorted(set(range(len(paths))) - set(good)):
            output.add(i, None, None)

    if good:
        transform = initialize_transforms(data_params["transforms"],
                                          mean_std=data_params["mean_std"])
        vecs = extract_vectors_network(
            network, [paths[i] for i in good], image_size, transform,
            bbxs=[bbxs[i] for i in good] if bbxs is not None else None,
            loader=loader)
        for col, i in enumerate(good):
            output.add(i, np.empty(0), vecs[:, col])
            meter.update(i)
    return len(paths)


def _run_translation(network, output, remaining, data_params, dataset,
                     meter):
    if _translator_divisor(network) is None:
        return None
    image_dir = dataset.pop("image_dir")
    image_size = dataset.pop("image_size", None)
    loader = dataset.pop("loader", pil_loader)
    if dataset.pop("ignore_errors", False) or dataset:
        # rgb outputs cannot take the `{}` sentinel; keep the per-item path
        return None

    transform = initialize_transforms(data_params["transforms"],
                                      mean_std=data_params["mean_std"])
    mean_std = _plain_normalize_chain(transform)

    def deliver(index, inp, out):
        output.add(index, inp, out)
        meter.update(index)

    if mean_std is None:
        on_device(transform, network.device)
    translator = StreamingTranslator(network, deliver, mean_std=mean_std)
    source = ImagesFromList(
        [path_join(image_dir, name) for name in remaining[0]],
        imsize=image_size, loader=loader,
        transform=None if mean_std is not None else transform)
    for i in range(len(source)):
        translator.add(i, source.uint8(i) if mean_std is not None
                       else source[i])
    translator.finish()
    return len(source)


def _host(out):
    """A network output as numpy: images NHWC, descriptors as they come."""
    out = out.detach().cpu()
    if out.dim() == 4:
        out = out.permute(0, 2, 3, 1)
    return out.numpy()


def _run_per_item(network, output, remaining, data_params, meter):
    """The reference's per-item loader loop."""
    loader = initialize_dataset_loader(remaining, "test", data_params,
                                       {"batch_size": 1})
    on_device(loader.dataset.transform, network.device)
    for i, indata in enumerate(loader):
        if isinstance(indata, dict) and indata == {}:
            output.add(i, None, None)
        else:
            with torch.no_grad():
                output.add(i, indata, _host(network(indata[0])))
        meter.update(i)
