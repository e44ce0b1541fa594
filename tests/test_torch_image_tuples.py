"""The image-tuple datasets of image-to-image training
(``data/datasets.py``: ``RandomImageTuple``, ``PregeneratedImageTuple``)
against the JAX package's: the same picks for every ``idx`` form (``any``,
``different``, an int, a negative int) over two epochs reseeded as the
training epoch reseeds them, the pregenerated picks of ``random.Random(0)``
fixed at init, and the loader's ``(input, target)`` collation per slot, with
the items bit-equal through one transform.
"""
import json
import random

import numpy as np
import pytest

from mdir_tpu.data.datasets import initialize_dataset_loader as \
    jax_dataset_loader

from mdir_tpu_torch.data.datasets import (PregeneratedImageTupleDataset,
                                          RandomImageTupleDataset,
                                          initialize_dataset_loader)

Image = pytest.importorskip("PIL.Image")

MEAN_STD = [[0.5] * 3, [0.5] * 3]
IDX = ["any_different", "0_-1", "1_different_any", "-1_0", "any_any"]


@pytest.fixture(scope="module")
def tuples_tsv(tmp_path_factory):
    """Rows of 2 to 5 images of 12x16 (a place's day and night shots)."""
    root = tmp_path_factory.mktemp("image_tuples")
    rng = np.random.RandomState(1)
    rows = []
    for i in range(7):
        row = []
        for j in range(2 + i % 4):
            name = "r%d_%d.png" % (i, j)
            Image.fromarray(rng.randint(0, 256, (12, 16, 3)).astype(
                np.uint8)).save(root / name)
            row.append(name)
        rows.append(row)
    with open(root / "tuples.tsv", "w") as handle:
        handle.write("pair\n")
        for row in rows:
            handle.write(json.dumps(row) + "\n")
    return root


def _section(root, label, idx, transforms="pil2np | totensor | normalize"):
    return {"mean_std": MEAN_STD, "transforms": transforms,
            "dataset": {"name": label, "dataset": str(root / "tuples.tsv"),
                        "data_key": "pair", "image_dir": str(root),
                        "idx": idx},
            "loader": {"batch_size": 3, "num_workers": 0}}


def _picks(make, root, label, idx):
    loader = make((), "train", _section(root, label, idx))
    picks = []
    for epoch in range(2):
        np.random.seed(epoch)
        random.seed(epoch)
        loader.dataset.prepare_epoch(None)
        picks.append([list(p) for p in loader.dataset.epoch_images])
    return picks


@pytest.mark.parametrize("label", ["RandomImageTuple",
                                   "PregeneratedImageTuple"])
@pytest.mark.parametrize("idx", IDX)
def test_picks_match_jax(tuples_tsv, label, idx):
    got = _picks(initialize_dataset_loader, tuples_tsv, label, idx)
    want = _picks(jax_dataset_loader, tuples_tsv, label, idx)
    assert got == want
    assert all(len(p) == len(idx.split("_")) for p in got[0])
    if label == "PregeneratedImageTuple":
        assert got[0] == got[1]
    if idx == "any_different":
        assert all(len(set(p)) == len(p) for p in got[0] + got[1])


def test_loader_collates_pairs_as_jax(tuples_tsv):
    """Input and target slots stacked as (N, H, W, C), bit-equal."""
    batches = []
    for make in (initialize_dataset_loader, jax_dataset_loader):
        loader = make((), "train", _section(
            tuples_tsv, "PregeneratedImageTuple", "0_-1",
            "pil2np | mirror | totensor | normalize"))
        np.random.seed(0)
        random.seed(0)
        batches.append(list(loader))
    for got, want in zip(*batches):
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert isinstance(a, np.ndarray) and a.shape[1:] == (12, 16, 3)
            np.testing.assert_array_equal(a, b)


def test_loader_hook_and_bad_index(tuples_tsv):
    """A Python scenario's ``loader`` replaces the PIL decode; an index past
    a row raises."""
    arrays = {}

    def load(path):
        arrays[path] = np.full((4, 6, 3), len(arrays), np.uint8)
        return arrays[path]

    dataset = PregeneratedImageTupleDataset(
        (), None, str(tuples_tsv / "tuples.tsv"), "pair", str(tuples_tsv),
        "0_1", loader=load)
    first = dataset[0]
    assert [a is arrays[p] for a, p in zip(first, dataset.epoch_images[0])] \
        == [True, True]
    with pytest.raises(IndexError):
        RandomImageTupleDataset((), None, str(tuples_tsv / "tuples.tsv"),
                                "pair", str(tuples_tsv), "5") \
            .prepare_epoch(None)
