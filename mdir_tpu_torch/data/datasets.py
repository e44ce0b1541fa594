"""The datasets of ``mdir_tpu/data/datasets.py``: training tuples with
per-epoch hard-negative mining (``TuplesDataset``, cirtorch
``traindataset.py``), the image tuples of image-to-image training
(``RandomImageTuple``, ``PregeneratedImageTuple``: day/night pairs from a
file reader) and the infer stage's image list (``CirImageList``,
``data/images.ImagesFromList``).

An image-tuple dataset reads one column of a file (``data_key``; each cell
a list of image names, one row a place) and picks, per row, the images its
``idx`` names (underscore-joined ``any`` | ``different`` | an int, negative
from the end): ``RandomImageTuple`` anew at each epoch's ``prepare_epoch``
from ``np.random.randint``, ``PregeneratedImageTuple`` once at init from
``random.Random(0).randrange``, as the JAX package draws them. An item is
the picked images decoded (``imread_rgb``, PIL imported there; a scenario
built in Python may give a ``loader`` from a path to an image) and run
through the transform together, so one draw crops or flips them alike.

Each epoch ``create_epoch_tuples`` draws the query subset and the negative
pool from the global numpy RNG in the JAX package's order, extracts the
queries' and the pool's descriptors in eval mode by the path extraction
takes (``parallel/extract.py::descriptors_of``: a composition's or a single
net's batched extractor, with uint8 pixels, the device chain and the
GeM+L2N kernel on the card, or the per-image path), ranks the pool on the
network's device and picks, per query, the first ``nnum`` pool images of
distinct clusters other than the query's on the host. The last mining's
descriptors, scores, ranks and picked rank positions stay in ``mined``;
``selection_gap`` reads from them how close the picks came to a tie.

With ``device_cache_mb`` (the dataset section's key; 0 is off, as the JAX
package's unset ``MDIR_TPU_DEVICE_CACHE_MB``) mining extracts through the
process's device image cache on the network's device
(``parallel/device_cache.py::shared_cache``): from the second epoch the
fixed query pool and the pool images it drew before are neither loaded nor
copied again. When the training items are raw uint8 for the device chain
(``item_transform``), ``__getitem__`` gives a ``CachedImageRef`` (its
entry's tensor) for an image the cache holds, and the train step assembles
its bucket from those entries on the card (the mining -> train hand-off, JAX ``datasets.py:233-319``).

The database comes from the scenario: ``dataset_pkl`` (a local pickle; the
port never downloads) and ``image_dir`` (default: ``ims`` beside the pickle,
the layout cirtorch downloads). Images come through ``loader``: by default
``data/images.pil_loader`` (PIL, imported when it runs); a scenario built in
Python may give its own ``loader``, a callable from a path to a PIL image or
an (H, W, 3) uint8 array. The longer side is shrunk to ``image_size`` as
PIL's ``thumbnail`` does; an array larger than that raises, since shrinking
it needs PIL.
"""
import os
import pickle
import random

import numpy as np
import torch

from ..ops.ranking import rank_database
from ..parallel.device_cache import CachedImageRef, shared_cache
from ..parallel.extract import descriptors_of
from ..tools.utils import path_join, validate_hash
from .images import ImagesFromList, as_uint8, imresize, pil_loader
from .loaders import DataLoader, collate_tuples
from .readers import initialize_file_reader


def imread_rgb(path):
    """Decode an image file to RGB with PIL (truncated files tolerated)."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    with open(path, "rb") as handle:
        return Image.open(handle).convert("RGB")


class RandomImageTupleDataset:
    """Image tuples (e.g. day/night pairs) with per-epoch random picks."""

    loader_params = {}

    def __init__(self, data, transform, dataset, data_key, image_dir, idx,
                 loader=imread_rgb):
        if data:
            raise ValueError("%s takes no stage data" % type(self).__name__)
        with initialize_file_reader(dataset, keys=[data_key]) as reader:
            image_list = reader.get()[data_key]
        self.image_list = [[path_join(image_dir, y) for y in x]
                           for x in image_list]
        self.transform = transform
        self.loader = loader
        if isinstance(idx, str):
            idx = [x if x in {"any", "different"} else int(x)
                   for x in idx.split("_")]
        self.idx = idx
        self.epoch_images = None

    @staticmethod
    def get_idx(idx, length, previous_idxs, rand):
        if idx == "any":
            return rand(length)
        if idx == "different":
            idxs = [x for x in range(length) if x not in previous_idxs]
            return idxs[rand(len(idxs))]
        if isinstance(idx, (list, tuple)):
            return rand(idx[0] or 0, idx[1] or length)
        if idx < 0:
            idx = length + idx
        if not 0 <= idx < length:
            raise IndexError("image index %d of a tuple of %d" % (idx, length))
        return idx

    def _generate_epoch_images(self, rand):
        self.epoch_images = []
        for possible in self.image_list:
            idxs = []
            for i in self.idx:
                idxs.append(self.get_idx(i, len(possible), idxs, rand))
            self.epoch_images.append([possible[i] for i in idxs])

    def prepare_epoch(self, network):
        del network  # the picks are random, not mined
        self._generate_epoch_images(np.random.randint)

    def __len__(self):
        return len(self.image_list)

    def __getitem__(self, index):
        images = [self.loader(x) for x in self.epoch_images[index]]
        if self.transform:
            images = self.transform(*images)
        return images


class PregeneratedImageTupleDataset(RandomImageTupleDataset):
    """Tuples fixed at init with seed 0, so a resume sees the same ones."""

    def __init__(self, data, transform, dataset, data_key, image_dir, idx,
                 loader=imread_rgb):
        super().__init__(data, transform, dataset, data_key, image_dir, idx,
                         loader)
        self._generate_epoch_images(random.Random(0).randrange)

    def prepare_epoch(self, network):
        del network


def cid2filename(cid, prefix):
    """3-level hashed directory layout of retrieval-SfM images."""
    if cid[0] == "/":
        return cid
    return os.path.join(prefix, cid[-2:], cid[-4:-2], cid[-6:-4], cid)


class TuplesDataset:
    """(q, p, n1..nN) training tuples over a retrieval-SfM database with
    per-epoch hard-negative re-mining against the current network."""

    item_transform = None  # the __getitem__-only transform (raw device input)

    def __init__(self, name, mode, imsize=None, nnum=5, qsize=2000,
                 poolsize=20000, transform=None, loader=pil_loader,
                 dataset_pkl=None, ims_root=None, device_cache_mb=0):
        if mode not in ("train", "val"):
            raise RuntimeError("MODE should be either train or val, passed "
                               "as string")
        if not name.startswith("retrieval-SfM"):
            raise RuntimeError("Unknown dataset name!")
        if dataset_pkl is None:
            raise ValueError("the port reads the database from the "
                             "scenario's dataset_pkl, which is not set")
        if str(dataset_pkl).startswith(("http://", "https://")):
            raise ValueError("the port does not download; fetch %s and pass "
                             "its local path" % dataset_pkl)
        with open(dataset_pkl, "rb") as handle:
            content = handle.read()
        validate_hash(content, str(dataset_pkl))
        db = pickle.loads(content)[mode]
        ims_root = ims_root or os.path.join(
            os.path.dirname(os.path.abspath(dataset_pkl)), "ims")

        self.images = [cid2filename(cid, ims_root) for cid in db["cids"]]
        self.name = name
        self.mode = mode
        self.imsize = imsize
        self.clusters = db["cluster"]
        self.qpool = db["qidxs"]
        self.ppool = db["pidxs"]

        self.nnum = nnum
        self.qsize = min(qsize, len(self.qpool))
        self.poolsize = min(poolsize, len(self.images))
        self.qidxs = None
        self.pidxs = None
        self.nidxs = None

        self.transform = transform
        self.loader = loader
        self.loader_params = {"drop_last": True, "collate_fn": collate_tuples}
        self.device_cache_mb = device_cache_mb
        self.device_cache = None  # the shared cache, taken when mining

    def __len__(self):
        return self.qsize

    def cache_key(self, index):
        """Image ``index``'s device cache key (JAX ``_feed_uint8``'s)."""
        return "%s@%s" % (self.images[index], self.imsize)

    def load(self, index):
        """Image ``index`` loaded and shrunk to ``imsize``."""
        img = self.loader(self.images[index])
        if isinstance(img, Exception):
            raise img
        return img if self.imsize is None else imresize(img, self.imsize)

    def __getitem__(self, index):
        if self.qidxs is None:
            raise RuntimeError("Run dataset.prepare_epoch(network) to create "
                               "the epoch subset")
        transform = self.item_transform or self.transform
        # the hand-off: raw device-chain items that the cache holds
        cache = self.device_cache if self.item_transform is not None \
            else None
        output = []
        for idx in [self.qidxs[index], self.pidxs[index]] \
                + list(self.nidxs[index]):
            key = self.cache_key(idx)
            hit = cache.get(key) if cache is not None else None
            if hit is not None:
                output.append(CachedImageRef(key, hit[1], hit[0]))
                continue
            img = self.load(idx)
            output.append(transform(img) if transform is not None else img)
        target = np.array([-1, 1] + [0] * len(self.nidxs[index]),
                          np.float32)
        return output, target

    def prepare_epoch(self, network):
        return self.create_epoch_tuples(network)

    def descriptors(self, network, indices):
        """(D, len(indices)) descriptors of images ``indices`` in eval mode,
        by the extraction path the network takes
        (``parallel/extract.py::descriptors_of``), through the device
        cache when there is one."""
        def decoded(uint8, positions=None):
            for p in range(len(indices)) if positions is None else positions:
                img = self.load(indices[p])
                yield as_uint8(img) if uint8 else self.transform(img)

        return descriptors_of(
            network, decoded, len(indices), self.transform,
            cache=self.device_cache,
            keys=[self.cache_key(idx) for idx in indices])

    def create_epoch_tuples(self, network):
        """Re-mine hard negatives with the current network."""
        print(">> Creating tuples for an epoch of %s-%s..."
              % (self.name, self.mode))
        self.device_cache = shared_cache(network.device, self.device_cache_mb)
        idxs2qpool = np.random.permutation(len(self.qpool))[:self.qsize]
        self.qidxs = [self.qpool[i] for i in idxs2qpool]
        self.pidxs = [self.ppool[i] for i in idxs2qpool]

        if self.nnum == 0:
            self.nidxs = [[] for _ in range(len(self.qidxs))]
            return 0

        idxs2images = np.random.permutation(len(self.images))[:self.poolsize]

        print(">> Extracting descriptors for query images...")
        qvecs = self.descriptors(network, self.qidxs)  # (D, Q)
        print(">> Extracting descriptors for negative pool...")
        poolvecs = self.descriptors(network, idxs2images)  # (D, P)
        if self.device_cache is not None:
            print(">>>> Device image cache: %s" % self.device_cache.stats())

        print(">> Searching for hard negatives...")
        pool_t, q_t = (torch.from_numpy(np.ascontiguousarray(v)).to(
            network.device) for v in (poolvecs, qvecs))
        ranks = rank_database(pool_t, q_t).cpu().numpy()

        ndist_acc = []
        self.nidxs = []
        positions = []  # the rank positions picked, per query
        for q in range(len(self.qidxs)):
            clusters = [self.clusters[self.qidxs[q]]]
            nidxs = []
            positions.append([])
            r = 0
            while len(nidxs) < self.nnum:
                if r >= ranks.shape[0]:
                    raise ValueError(
                        "hard-negative mining exhausted the pool: query %d "
                        "found %d/%d distinct-cluster negatives in a pool "
                        "of %d — raise pool_size or lower neg_num"
                        % (q, len(nidxs), self.nnum, ranks.shape[0]))
                potential = idxs2images[ranks[r, q]]
                if self.clusters[potential] not in clusters:
                    nidxs.append(int(potential))
                    positions[-1].append(r)
                    clusters.append(self.clusters[potential])
                    diff = qvecs[:, q] - poolvecs[:, ranks[r, q]] + 1e-6
                    ndist_acc.append(float(np.sqrt(np.sum(diff ** 2))))
                r += 1
            self.nidxs.append(nidxs)
        self.mined = {"qvecs": qvecs, "poolvecs": poolvecs,
                      "scores": (pool_t.T @ q_t).cpu().numpy(),
                      "ranks": ranks, "positions": positions}
        print(">>>> Average negative l2-distance: %.2f"
              % (np.mean(ndist_acc) if ndist_acc else 0.0))
        return {"average_negative_distance": ndist_acc}


def selection_gap(scores, ranks, positions, **_):
    """The smallest score gap the picked negatives relied on: between each
    picked pool image and the next one in its query's ranking, and between
    two picks that are neighbours there. ``scores`` (P, Q) are the scores
    the ranking sorted. Scores that move by less than half of it pick the
    same negatives in the same order."""
    gaps = []
    for q, picked in enumerate(positions):
        ranked = scores[ranks[:, q], q]
        for r in picked:
            if r + 1 < len(ranked):
                gaps.append(ranked[r] - ranked[r + 1])
            if r - 1 in picked:
                gaps.append(ranked[r - 1] - ranked[r])
    return float(min(gaps)) if gaps else float("inf")


def cir_tuples_dataset(data, transform, **params):
    """The scenario's ``CirTuples`` dataset section -> TuplesDataset."""
    if data:
        raise ValueError("CirTuples takes no stage data")
    dataset = TuplesDataset(
        name=params.pop("dataset"),
        mode=params.pop("split"),
        imsize=params.pop("image_size"),
        nnum=params.pop("neg_num"),
        transform=transform,
        loader=params.pop("loader", pil_loader),
        dataset_pkl=params.pop("dataset_pkl"),
        ims_root=params.pop("image_dir"),
        qsize=params.pop("query_size"),
        poolsize=params.pop("pool_size"),
        device_cache_mb=params.pop("device_cache_mb", 0),
    )
    if params:
        raise ValueError("unknown CirTuples keys: %s" % sorted(params))
    return dataset


def cir_image_list_dataset(data, transform, **params):
    """The scenario's ``CirImageList`` section -> ImagesFromList over
    ``image_dir``'s images (with bounding boxes when ``data`` has them);
    ``loader`` and ``ignore_errors`` pass through."""
    images, bbxs = (data[0], None) if len(data) == 1 else data
    image_dir = params.pop("image_dir")
    return ImagesFromList(
        images=[path_join(image_dir, x) for x in images],
        imsize=params.pop("image_size"),
        bbxs=bbxs,
        transform=transform,
        **params)


DATASET_LABELS = {
    "RandomImageTuple": RandomImageTupleDataset,
    "PregeneratedImageTuple": PregeneratedImageTupleDataset,
    "CirTuples": cir_tuples_dataset,
    "CirImageList": cir_image_list_dataset,
}

LOADER_DEFAULT_PARAMS = {
    "shuffle": False,
    "num_workers": 6,
    "pin_memory": True,
}


def initialize_dataset(data, stage, transform, params):
    if stage in ("train", "val"):
        if data:
            col_start, col_end = params.pop("data_cols").split(":")
            data = data[int(col_start):(int(col_end) if col_end else None)]
    elif stage != "test":
        raise RuntimeError("Unsupported stage '%s'" % stage)
    label = params.pop("name")
    if label not in DATASET_LABELS:
        raise KeyError("unknown dataset %r (the port has %s)"
                       % (label, sorted(DATASET_LABELS)))
    return DATASET_LABELS[label](data, transform=transform, **params)


def initialize_dataset_loader(data, stage, params, loader_default_params=None):
    from .transforms import initialize_transforms

    transform = initialize_transforms(params.pop("transforms"),
                                      mean_std=params.pop("mean_std"))
    dataset = initialize_dataset(data, stage, transform, params.pop("dataset"))
    loader_params = {**LOADER_DEFAULT_PARAMS, **(loader_default_params or {}),
                     **getattr(dataset, "loader_params", {}),
                     **params.pop("loader", {})}
    if "batch_size" not in loader_params or params:
        raise ValueError("a dataset section needs loader: batch_size and no "
                         "other keys than transforms, mean_std, dataset and "
                         "loader; left: %s" % sorted(params))
    return DataLoader(dataset, **loader_params)
