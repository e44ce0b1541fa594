"""Retrieval evaluation scores.

``CirDatasetAp`` (reference ``mdir/components/optim/score/cirscore.py``, as
``mdir_tpu/optim/scores.py``): configures from the official gnd pkl
(roxford5k/rparis6k/247tokyo1k/...) or tsv db/query files, extracts database
and query descriptors through the network's batched path, ranks with one
matrix product on the network's device, scores with the junk-aware mAP
protocol and logs per-query AP and the averages.
"""
import os

import numpy as np
import torch

from ..data.readers import initialize_file_reader
from ..data.testdata import configdataset
from ..data.transforms import initialize_transforms
from ..ops.ranking import compute_map_and_print, rank_database
from ..parallel.extract import extract_vectors_network
from ..tools.utils import get_data_root, path_join


class CirDatasetAp:

    def __init__(self, params):
        self.image_size = params.pop("image_size")
        self.dataset = params.pop("dataset")
        self.transforms = initialize_transforms(params.pop("transforms"),
                                                params.pop("mean_std"))
        if params.pop("parallel", None) is not None:
            raise NotImplementedError("multi-card eval is not ported yet")

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
        print(">> {}: database images...".format(self.dataset))
        vecs = extract_vectors_network(network, self.images, self.image_size,
                                       self.transforms)
        print(">> {}: query images...".format(self.dataset))
        if self.images == self.qimages and set(self.bbxs) == {None}:
            qvecs = vecs
        else:
            qvecs = extract_vectors_network(network, self.qimages,
                                            self.image_size, self.transforms,
                                            bbxs=self.bbxs)
        print(">> {}: Evaluating...".format(self.dataset))
        ranks = rank_database(
            torch.from_numpy(np.ascontiguousarray(vecs)).to(network.device),
            torch.from_numpy(np.ascontiguousarray(qvecs)).to(network.device))
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
