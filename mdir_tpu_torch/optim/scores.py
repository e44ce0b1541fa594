"""Retrieval evaluation scores.

``CirDatasetAp`` (reference ``mdir/components/optim/score/cirscore.py``, as
``mdir_tpu/optim/scores.py``): configures from the official gnd pkl
(roxford5k/rparis6k/247tokyo1k/...) or tsv db/query files, extracts database
and query descriptors through the network's batched path, ranks with one
matrix product on the network's device, scores with the junk-aware mAP
protocol and logs per-query AP and the averages.

With ``parallel: {data: N}`` (JAX ``scores.py:30-36, 78-106``) the database
and query images are extracted with each chunk sharded over the N ranks
of the process group (``parallel/mesh.py``) and the database's columns are
ranked sharded (``rank_database_sharded``); every rank returns the same
scores. A scenario built in Python may give a ``loader`` (a path to a PIL
image or an (H, W, 3) uint8 array), as the datasets take.

``device_cache_mb`` (JAX: ``MDIR_TPU_DEVICE_CACHE_MB``, ``scores.py:66-97``)
extracts both sets through the process's device image cache on the
network's device (``parallel/device_cache.py::shared_cache``, the one the
training tuples use), so each later validation of the same images skips
their loading; the sharded extractor of ``parallel`` takes no cache.
"""
import os

import numpy as np
import torch

from ..data.readers import initialize_file_reader
from ..data.testdata import configdataset
from ..data.transforms import initialize_transforms
from ..ops.ranking import (compute_map_and_print, rank_database,
                           rank_database_sharded)
from ..parallel.device_cache import shared_cache
from ..parallel.extract import extract_vectors_network
from ..parallel.mesh import make_mesh
from ..tools.utils import get_data_root, path_join


class CirDatasetAp:

    def __init__(self, params):
        self.image_size = params.pop("image_size")
        self.dataset = params.pop("dataset")
        self.transforms = initialize_transforms(params.pop("transforms"),
                                                params.pop("mean_std"))
        self.parallel = params.pop("parallel", None)
        if self.parallel is not None and set(self.parallel) != {"data"}:
            raise ValueError("parallel takes data only, not %s"
                             % sorted(self.parallel))
        self.loader = params.pop("loader", None)
        self.device_cache_mb = params.pop("device_cache_mb", 0)

        if isinstance(self.dataset, dict):
            assert self.dataset.keys() == {"name", "queries", "db", "imgdir"}
            imgdir = self.dataset["imgdir"]
            with initialize_file_reader(self.dataset["db"],
                                        keys=["identifier"]) as reader:
                data = reader.get()
                self.images = [path_join(imgdir, x)
                               for x in data["identifier"]]
                mapping = {x: i for i, x in enumerate(data["identifier"])}
            with initialize_file_reader(
                    self.dataset["queries"],
                    keys=["query", "bbx", "ok", "junk"]) as reader:
                data = reader.get()
                self.qimages = [path_join(imgdir, x) for x in data["query"]]
                self.bbxs = [tuple(x) if x else None for x in data["bbx"]]
                self.gnd = [{"ok": [mapping[x] for x in ok],
                             "junk": [mapping[x] for x in junk]}
                            for ok, junk in zip(data["ok"], data["junk"])]
            self.dataset = self.dataset["name"]
        else:
            cfg = configdataset(self.dataset,
                                os.path.join(get_data_root(), "test"))
            self.images = [cfg["im_fname"](cfg, i) for i in range(cfg["n"])]
            self.qimages = [cfg["qim_fname"](cfg, i)
                            for i in range(cfg["nq"])]
            self.bbxs = [tuple(cfg["gnd"][i]["bbx"]) if cfg["gnd"][i]["bbx"]
                         else None for i in range(cfg["nq"])]
            self.gnd = cfg["gnd"]
        assert not params, params.keys()

    def __call__(self, network, logger=None):
        mesh = None if self.parallel is None \
            else make_mesh(self.parallel["data"], network.device)
        cache = shared_cache(network.device, self.device_cache_mb)
        print(">> {}: database images...".format(self.dataset))
        vecs = extract_vectors_network(network, self.images, self.image_size,
                                       self.transforms, loader=self.loader,
                                       mesh=mesh, cache=cache)
        print(">> {}: query images...".format(self.dataset))
        if self.images == self.qimages and set(self.bbxs) == {None}:
            qvecs = vecs
        else:
            qvecs = extract_vectors_network(network, self.qimages,
                                            self.image_size, self.transforms,
                                            bbxs=self.bbxs, loader=self.loader,
                                            mesh=mesh, cache=cache)
        print(">> {}: Evaluating...".format(self.dataset))
        vecs, qvecs = (torch.from_numpy(np.ascontiguousarray(v)).to(
            network.device) for v in (vecs, qvecs))
        ranks = rank_database(vecs, qvecs) if mesh is None \
            else rank_database_sharded(vecs, qvecs, mesh)
        averages, scores = compute_map_and_print(self.dataset,
                                                 ranks.cpu().numpy(), self.gnd)
        if logger is not None:
            first_score = scores[list(scores.keys())[0]]
            logger(None, len(first_score), "score_avg", averages,
                   "scalar/score")
            assert len({len(x) for x in scores.values()}) == 1
            for i, _ in enumerate(first_score):
                logger(i, len(first_score), "score",
                       {x: scores[x][i] for x in scores}, "scalar/score")
        return averages


SCORES = {
    "cirdatasetap": CirDatasetAp,
}


def initialize_score(params):
    params = dict(params)
    return SCORES[params.pop("type")](params)
