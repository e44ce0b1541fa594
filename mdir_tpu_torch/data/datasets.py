"""The datasets of ``mdir_tpu/data/datasets.py``: training tuples with
per-epoch hard-negative mining (``TuplesDataset``, cirtorch
``traindataset.py``) and the infer stage's image list (``CirImageList``,
``data/images.ImagesFromList``).

Each epoch ``create_epoch_tuples`` draws the query subset and the negative
pool from the global numpy RNG in the JAX package's order, extracts the
queries' and the pool's descriptors in eval mode through the network's
batched extractor (``parallel/extract.py::network_extractor``: uint8 pixels,
the device chain and the GeM+L2N kernel on the card), ranks the pool on the
network's device and picks, per query, the first ``nnum`` pool images of
distinct clusters other than the query's on the host. The last mining's
descriptors, scores, ranks and picked rank positions stay in ``mined``;
``selection_gap`` reads from them how close the picks came to a tie.

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

import numpy as np
import torch

from ..ops.ranking import rank_database
from ..parallel.extract import network_extractor
from ..tools.utils import path_join, validate_hash
from .images import ImagesFromList, as_uint8, imresize, pil_loader
from .loaders import DataLoader, collate_tuples

NOT_PORTED = "ROADMAP §1.6"


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
                 dataset_pkl=None, ims_root=None):
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

    def __len__(self):
        return self.qsize

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
        output = []
        for idx in [self.qidxs[index], self.pidxs[index]] \
                + list(self.nidxs[index]):
            img = self.load(idx)
            output.append(transform(img) if transform is not None else img)
        target = np.array([-1, 1] + [0] * len(self.nidxs[index]),
                          np.float32)
        return output, target

    def prepare_epoch(self, network):
        return self.create_epoch_tuples(network)

    def descriptors(self, network, indices):
        """(D, len(indices)) descriptors of images ``indices`` through the
        network's batched extractor, in eval mode."""
        network.eval()
        extractor = network_extractor(network, self.transform)
        uint8 = extractor.host_dtype == np.uint8
        for i, idx in enumerate(indices):
            img = self.load(idx)
            extractor.add(i, as_uint8(img) if uint8 else self.transform(img))
        return extractor.finish(len(indices))

    def create_epoch_tuples(self, network):
        """Re-mine hard negatives with the current network."""
        print(">> Creating tuples for an epoch of %s-%s..."
              % (self.name, self.mode))
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
        raise NotImplementedError(
            "dataset %r is not ported yet (the port has CirTuples and "
            "CirImageList; the image-tuple datasets of image-to-image "
            "nets: %s)"
            % (label, NOT_PORTED))
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
