"""The port's device image cache (``parallel/device_cache.py``) and the
mining -> train hand-off against the JAX package's
(``mdir_tpu/parallel/device_cache.py``), with inputs made from a numpy
seed, AlexNet-GeM at images under 128 px, torch on one thread:

* the same put/get/peek sequence gives equal ``stats()``, the same
  surviving keys in the same LRU order and the same ``matches()`` answers;
* ``assemble`` is bit-equal to JAX ``assemble_train_batch`` and to
  ``pad_image_batch`` on JAX's mixed-shape case, with the same
  ``miss_bytes`` and no hit counted;
* cached extraction on the plain and the lab CLAHE routes (the cold fill,
  all hits, mixed hits) is bit-equal to the port's uncached extraction and
  within 1e-4 of the JAX package's with a cache; a hit is never loaded;
* mining with ``device_cache_mb`` picks in epoch 2 what the uncached port
  and the JAX package (``MDIR_TPU_DEVICE_CACHE_MB``) pick, and a per-tuple
  and a whole-batch step on the items it hands off give the uncached
  step's loss and gradients bit for bit (float32 on the CPU: the buckets
  are the same bytes);
* the training tuples and a validation score share one cache whose bytes
  stay within the larger budget; a world-2 gloo score with ``parallel:
  {data: 2}`` keeps no entries; a loader's ndarray goes through the resize
  and the transform, never as a reference.
"""
import json
import os
import pickle

import numpy as np
import pytest

import jax
import torch

from mdir_tpu.data.datasets import TuplesDataset as JaxTuplesDataset
from mdir_tpu.data.transforms import initialize_transforms as jax_transforms
from mdir_tpu.learning.network import CirNetwork as JaxCirNetwork
from mdir_tpu.learning.train_step import pad_image_batch as jax_pad_batch
from mdir_tpu.models import initialize_model as jax_initialize_model
from mdir_tpu.parallel import device_cache as jax_cache
from mdir_tpu.parallel.extract import \
    extract_vectors_network as jax_extract_network

from mdir_tpu_torch.data import datasets
from mdir_tpu_torch.data.datasets import TuplesDataset
from mdir_tpu_torch.data.images import pil_loader
from mdir_tpu_torch.data.transforms import initialize_transforms
from mdir_tpu_torch.learning.network import CirNetwork
from mdir_tpu_torch.learning.train_step import TrainStep, pad_image_batch
from mdir_tpu_torch.models import initialize_model
from mdir_tpu_torch.models.convert import from_jax_variables
from mdir_tpu_torch.ops.preprocess import RawChainInput, chain_from_transform
from mdir_tpu_torch.optim.criteria import initialize_criterion
from mdir_tpu_torch.optim.scores import initialize_score
from mdir_tpu_torch.parallel import device_cache
from mdir_tpu_torch.parallel.device_cache import (CachedImageRef,
                                                  DeviceImageCache,
                                                  assemble, shared_cache)
from mdir_tpu_torch.parallel.extract import (StreamingExtractor,
                                             extract_vectors_network)
from mdir_tpu_torch.parallel.mesh import launch

MEAN_STD = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
PLAIN = "pil2np | totensor | normalize"
CLAHE = "pil2np | apply_clahe:4:lab:8 | totensor | normalize"
MODEL = {"architecture": "cirnet", "cir_architecture": "alexnet",
         "local_whitening": False, "pooling": "gem", "regional": False,
         "whitening": False, "pretrained": False}
RUNTIME = {"wrappers": "", "data": {"mean_std": MEAN_STD}}
CRITERION = {"loss": "contrastive", "margin": 0.7, "eps": 1e-6}


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache; torch
    on one intra-op thread beside the other test workers."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old, threads = getattr(jax.config, key), torch.get_num_threads()
    jax.config.update(key, 1e9)
    torch.set_num_threads(1)
    yield
    jax.config.update(key, old)
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_shared_caches(monkeypatch):
    """Each test starts without the process's shared caches."""
    monkeypatch.setattr(device_cache, "_SHARED", {})


@pytest.fixture(scope="module")
def networks():
    """AlexNet-GeM in both packages with the JAX package's weights."""
    model = jax_initialize_model(dict(MODEL))
    jax_net = JaxCirNetwork(model, JaxCirNetwork.NetworkParams(
        model=dict(MODEL), runtime=dict(RUNTIME)))
    port_model = initialize_model(dict(MODEL), device="cpu")
    port_model.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, model.variables)), strict=True)
    port_net = CirNetwork(port_model, CirNetwork.NetworkParams(
        model=dict(MODEL), runtime=dict(RUNTIME)))
    return jax_net.eval(), port_net.eval()


@pytest.fixture(scope="module")
def sfm(tmp_path_factory):
    """16 JPEGs of 48x64 (or 64x48) in 8 clusters of 2 crops of a smooth
    colour field with noise, their database pickle (queries 0, 2, 4, 6)
    and tsv db/query files of the first 8."""
    from PIL import Image

    root = tmp_path_factory.mktemp("sfm")
    rng = np.random.RandomState(3)
    fields = torch.nn.functional.interpolate(
        torch.from_numpy(rng.rand(8, 3, 3, 4).astype(np.float32)),
        size=(80, 80), mode="bilinear", align_corners=False).numpy()
    cids = []
    for i in range(16):
        h, w = (48, 64) if i % 3 else (64, 48)
        y, x = rng.randint(0, 80 - h + 1), rng.randint(0, 80 - w + 1)
        img = fields[i // 2, :, y:y + h, x:x + w].transpose(1, 2, 0) * 255
        img = np.clip(img + rng.randn(h, w, 3) * 8, 0, 255)
        name = str(root / ("im%03d.jpg" % i))
        Image.fromarray(img.astype(np.uint8)).save(name, quality=95)
        cids.append(name)
    split = {"cids": cids, "cluster": [i // 2 for i in range(16)],
             "qidxs": [0, 2, 4, 6], "pidxs": [1, 3, 5, 7]}
    with open(root / "db.pkl", "wb") as handle:
        pickle.dump({"train": split}, handle)
    with open(root / "db.tsv", "w") as handle:
        handle.write("identifier\n")
        handle.writelines("im%03d.jpg\n" % i for i in range(8))
    with open(root / "queries.tsv", "w") as handle:
        handle.write("query\tbbx\tok\tjunk\n")
        handle.write("im000.jpg\t\t%s\t%s\n" % (json.dumps(["im001.jpg"]),
                                                json.dumps([])))
    return {"root": str(root), "pkl": str(root / "db.pkl"), "paths": cids}


def once_loader(paths_loaded):
    """pil_loader that records each path and raises on a second load."""
    def load(path):
        if path in paths_loaded:
            raise AssertionError("%s loaded twice" % path)
        paths_loaded.append(path)
        return pil_loader(path)
    return load


def test_lru_sequence_matches_jax():
    """One random put/get/peek sequence on a 100 kB budget: equal stats,
    the same keys in the same LRU order, the same matches() answers."""
    rng = np.random.RandomState(0)
    ours = DeviceImageCache(0.1, "cpu")
    ref = jax_cache.DeviceImageCache(0.1)
    keys = ["k%d" % i for i in range(10)]
    for _ in range(200):
        key = keys[rng.randint(len(keys))]
        op = rng.randint(3)
        if op == 0:
            h, w = rng.randint(1, 90, size=2)
            padded = np.zeros((-(-h // 64) * 64, -(-w // 64) * 64, 3),
                              np.uint8)
            padded[:h, :w] = rng.randint(0, 256, (h, w, 3))
            np.testing.assert_array_equal(
                ours.put(key, padded, (h, w)).numpy(),
                np.asarray(ref.put(key, padded, (h, w))))
        elif op == 1:
            got, expected = ours.get(key), ref.get(key)
            assert (got is None) == (expected is None)
            if got is not None:
                np.testing.assert_array_equal(got[0].numpy(),
                                              np.asarray(expected[0]))
                assert got[1] == expected[1]
        elif ref.contains(key):
            np.testing.assert_array_equal(ours.peek(key).numpy(),
                                          np.asarray(ref.peek(key)))
        assert ours.stats() == ref.stats()
        assert list(ours._entries) == list(ref._entries)
        for k in keys:
            assert ours.contains(k) == ref.contains(k)
            if ref.contains(k):
                assert ours.shape(k) == ref.shape(k)
            for multiple in (32, 64, 128):
                assert ours.matches(k, multiple) == ref.matches(k, multiple)
    assert ours.stats()["evictions"] > 0 and ours.stats()["hits"] > 0
    ours.clear()
    assert ours.stats()["entries"] == ours.stats()["bytes"] == 0


def test_assemble_matches_jax_and_pad_image_batch():
    """JAX's mixed-shape case (``tests/test_device_cache.py``): hits padded
    at mining's 64-bucketing, misses as arrays, the train bucket at 32."""
    rng = np.random.RandomState(9)
    ours = DeviceImageCache(64, "cpu")
    ref = jax_cache.DeviceImageCache(64)
    shapes = [(48, 64), (64, 48), (37, 61), (64, 64), (20, 33)]
    images = [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in shapes]
    flat, jax_flat = [], []
    for i, img in enumerate(images):
        if i % 2:
            flat.append(img)
            jax_flat.append(img)
            continue
        h, w = img.shape[:2]
        padded = np.zeros((-(-h // 64) * 64, -(-w // 64) * 64, 3), np.uint8)
        padded[:h, :w] = img
        entry = ours.put("im%d@64" % i, padded, (h, w))
        ref.put("im%d@64" % i, padded, (h, w))
        flat.append(CachedImageRef("im%d@64" % i, (h, w), entry))
        jax_flat.append(jax_cache.CachedImageRef("im%d@64" % i, (h, w)))

    bucket, valid, miss_bytes = assemble(flat, 32)
    jax_bucket, jax_valid, jax_miss = ref.assemble_train_batch(jax_flat, 32)
    host, host_valid = pad_image_batch(images, 32)
    assert bucket.dtype == torch.uint8 and bucket.device.type == "cpu"
    np.testing.assert_array_equal(bucket.numpy(), np.asarray(jax_bucket))
    np.testing.assert_array_equal(bucket.numpy(), host)
    np.testing.assert_array_equal(host, jax_pad_batch(images, 32)[0])
    np.testing.assert_array_equal(valid, jax_valid)
    np.testing.assert_array_equal(valid, host_valid)
    assert miss_bytes == jax_miss == sum(host[0].nbytes for i in (1, 3))
    assert ours.stats() == ref.stats()
    assert ours.stats()["hits"] == 0 and ours.stats()["misses"] == 0
    ours.clear()  # a ref holds its entry: an eviction cannot lose it
    np.testing.assert_array_equal(assemble(flat, 32)[0].numpy(), host)


@pytest.mark.parametrize("transform", [PLAIN, CLAHE])
def test_cached_extraction_bit_equal_and_matches_jax(networks, sfm,
                                                     transform, monkeypatch):
    """The cold fill of 5 of 8 images, then all 8 (3 new among them: mixed
    chunks), then all 8 again (all hits), in chunks of 3, each bit-equal
    to the uncached run of the same list (the same chunks: hits keep their
    place); the mixed run within 1e-4 of the JAX package's (its cache
    filled alike, its hits added first). A hit never reaches the loader."""
    jax_net, port_net = networks
    paths = sfm["paths"][:8]
    port_transform = initialize_transforms(transform, MEAN_STD)

    chunks = []  # each run's chunks, as image indices
    submit = StreamingExtractor._submit
    monkeypatch.setattr(StreamingExtractor, "_submit", lambda self, bucket: (
        chunks[-1].append([item[0] for item in self.buffers[bucket]]),
        submit(self, bucket)))

    def extract(images, **kwargs):
        chunks.append([])
        return extract_vectors_network(port_net, images, 96, port_transform,
                                       batch_size=3, **kwargs)

    cache = DeviceImageCache(100, "cpu")
    loaded = []
    first = [paths[i] for i in (0, 2, 4, 6, 7)]
    cold = extract(first, loader=once_loader(loaded), cache=cache)
    assert loaded == first
    assert cache.stats() == {"entries": 5, "bytes": 5 * 64 * 64 * 3,
                             "hits": 0, "misses": 0, "evictions": 0}
    mixed = extract(paths, loader=once_loader(loaded), cache=cache)
    assert loaded == first + [paths[i] for i in (1, 3, 5)]
    assert cache.stats()["hits"] == 5
    warm = extract(paths, loader=once_loader(loaded), cache=cache)
    assert cache.stats()["hits"] == 13 and cache.stats()["entries"] == 8
    np.testing.assert_array_equal(cold, extract(first))
    base = extract(paths)
    np.testing.assert_array_equal(mixed, base)
    np.testing.assert_array_equal(warm, base)
    assert chunks[1] == chunks[2] == chunks[4] == [[0, 1, 2], [3, 4, 5],
                                                   [6, 7]]

    jax_cached = jax_cache.DeviceImageCache(100)
    jax_transform = jax_transforms(transform, MEAN_STD)
    jax_extract_network(jax_net, first, 96, jax_transform,
                        batch_size=3, cache=jax_cached)
    reference = jax_extract_network(jax_net, paths, 96, jax_transform,
                                    batch_size=3, cache=jax_cached)
    assert jax_cached.stats() == cache.stats() | {"hits": 5}
    np.testing.assert_allclose(mixed, reference, rtol=0, atol=1e-4)


def mining_dataset(sfm, transform, **kwargs):
    return TuplesDataset(
        "retrieval-SfM-tiny", "train", imsize=64, nnum=2, qsize=4,
        poolsize=12, transform=initialize_transforms(transform, MEAN_STD),
        dataset_pkl=sfm["pkl"], **kwargs)


def test_mining_with_the_cache_picks_as_uncached_and_jax(networks, sfm,
                                                         monkeypatch):
    """Two epochs of lab CLAHE mining with ``device_cache_mb``: epoch 2
    hits, and its picks are the uncached port's and the JAX package's
    (its cache from the environment, on the JAX side only)."""
    jax_net, port_net = networks
    cached = mining_dataset(sfm, CLAHE, device_cache_mb=64)
    plain = mining_dataset(sfm, CLAHE)
    with monkeypatch.context() as mp:
        mp.setenv("MDIR_TPU_DEVICE_CACHE_MB", "64")
        jax_ds = JaxTuplesDataset(
            "retrieval-SfM-tiny", "train", imsize=64, nnum=2, qsize=4,
            poolsize=12, transform=jax_transforms(CLAHE, MEAN_STD),
            dataset_pkl=sfm["pkl"])
    assert jax_ds.device_cache is not None
    hits = [0]  # the epoch's hits: the pool's queries, then the pool too
    for epoch in range(2):
        for dataset in (cached, plain):
            np.random.seed(epoch)
            dataset.create_epoch_tuples(port_net)
        np.random.seed(epoch)
        jax_ds.create_epoch_tuples(jax_net)
        stats = cached.device_cache.stats()
        hits.append(stats["hits"])
        assert hits[-1] - hits[-2] > (4 if epoch else 0), stats
        counts = ("entries", "hits", "misses", "evictions")
        assert {k: stats[k] for k in counts} \
            == {k: jax_ds.device_cache.stats()[k] for k in counts}
        for dataset in (plain, jax_ds):
            assert cached.qidxs == dataset.qidxs
            assert cached.pidxs == dataset.pidxs
            assert cached.nidxs == dataset.nidxs
        for key in ("qvecs", "poolvecs"):
            np.testing.assert_array_equal(cached.mined[key],
                                          plain.mined[key])
    assert plain.device_cache is None
    assert cached.device_cache is shared_cache("cpu", 64)


@pytest.mark.parametrize("whole", [False, True])
def test_handoff_step_equals_the_uncached_step(networks, sfm, whole):
    """After lab CLAHE mining with the cache, the raw device-chain items of
    two tuples come as references where cached; one step on them (per
    tuple, or the whole batch as one bucket) gives the uncached step's
    loss and gradients exactly (float32, the same bucket bytes)."""
    _, port_net = networks
    dataset = mining_dataset(sfm, CLAHE, device_cache_mb=64)
    chain = chain_from_transform(dataset.transform)
    dataset.item_transform = RawChainInput()
    np.random.seed(0)
    dataset.create_epoch_tuples(port_net)
    items = [dataset[i] for i in range(2)]
    refs = [isinstance(img, CachedImageRef) for tpl, _ in items
            for img in tpl]
    assert 0 < sum(refs) < len(refs)  # hits and misses in one batch
    dataset.device_cache = None
    pixels = [tpl for tpl, _ in (dataset[i] for i in range(2))]
    targets = [target for _, target in items]
    results = []
    for images in ([tpl for tpl, _ in items], pixels):
        net = CirNetwork(initialize_model(dict(MODEL), device="cpu"),
                         port_net.network_params)
        net.model.load_state_dict(port_net.model.state_dict())
        step = TrainStep(net.train(), initialize_criterion(dict(CRITERION)),
                         device_chain=chain)
        step.whole = whole  # the whole-batch route on the same net
        loss, count = step.gradients(images, targets)
        assert count == 2
        results.append((float(loss), {name: p.grad.clone() for name, p
                                      in net.model.named_parameters()}))
    (loss, grads), (ref_loss, ref_grads) = results
    assert loss == ref_loss and np.isfinite(loss)
    for name, grad in ref_grads.items():
        assert torch.equal(grads[name], grad), name


def test_one_cache_for_tuples_and_score(networks, sfm, monkeypatch):
    """Mining at 0.1 MB and a validation score at 0.2 MB share one cache,
    whose budget is 0.2 MB and whose bytes never exceed it."""
    _, port_net = networks
    most = []
    put = DeviceImageCache.put

    def recorded_put(self, *args):
        out = put(self, *args)
        most.append(self.stats()["bytes"])
        return out

    monkeypatch.setattr(DeviceImageCache, "put", recorded_put)
    dataset = mining_dataset(sfm, PLAIN, device_cache_mb=0.1)
    np.random.seed(0)
    dataset.create_epoch_tuples(port_net)
    assert max(most) <= 0.1e6
    score = initialize_score({
        "type": "cirdatasetap", "image_size": 56,
        "dataset": {"name": "tiny", "db": os.path.join(sfm["root"], "db.tsv"),
                    "queries": os.path.join(sfm["root"], "queries.tsv"),
                    "imgdir": sfm["root"]},
        "transforms": PLAIN, "mean_std": MEAN_STD, "device_cache_mb": 0.2})
    score(port_net)  # at image size 56: 8 entries of keys of its own
    cache = dataset.device_cache
    assert cache is shared_cache("cpu", 0.1) and cache.budget_bytes == 2e5
    assert max(most) <= 0.2e6 and cache.stats()["evictions"] > 0
    assert max(most) > 0.1e6


def test_sharded_score_keeps_no_entries(networks, sfm):
    """``parallel: {data: 2}`` on a gloo world of 2: the sharded extractor
    drops the cache, as the JAX package's does."""
    import device_cache_ranks

    _, port_net = networks
    score = {
        "type": "cirdatasetap", "image_size": 64,
        "dataset": {"name": "tiny", "db": os.path.join(sfm["root"], "db.tsv"),
                    "queries": os.path.join(sfm["root"], "queries.tsv"),
                    "imgdir": sfm["root"]},
        "transforms": PLAIN, "mean_std": MEAN_STD, "device_cache_mb": 64,
        "parallel": {"data": 2}}
    ranks = launch(device_cache_ranks.score_and_cache, 2, "cpu",
                   (score, port_net.state_dict()))
    for averages, stats in ranks:
        assert np.isfinite(averages["map"])
        assert stats == {"entries": 0, "bytes": 0, "hits": 0, "misses": 0,
                         "evictions": 0}


def test_loader_arrays_go_through_resize_and_transform(networks, sfm,
                                                       monkeypatch):
    """A loader that returns ndarrays, its images all cached by mining:
    with a raw item transform each item is a reference to its entry; with
    the cache cleared each goes through ``imresize`` and the transform, as
    it does without an item transform (no reference then)."""
    _, port_net = networks
    arrays = {path: np.asarray(pil_loader(path)) for path in sfm["paths"]}
    resized, transformed = [], []
    imresize = datasets.imresize
    monkeypatch.setattr(datasets, "imresize", lambda img, size: resized.append(
        img.shape) or imresize(img, size))
    dataset = TuplesDataset(
        "retrieval-SfM-tiny", "train", imsize=64, nnum=2, qsize=4,
        poolsize=16, transform=initialize_transforms(PLAIN, MEAN_STD),
        dataset_pkl=sfm["pkl"], device_cache_mb=64, loader=arrays.__getitem__)
    np.random.seed(0)
    dataset.create_epoch_tuples(port_net)
    assert dataset.device_cache.stats()["entries"] == 16
    dataset.item_transform = lambda img: transformed.append(img) or img
    for q in range(len(dataset)):
        tpl, _ = dataset[q]
        for idx, img in zip([dataset.qidxs[q], dataset.pidxs[q]]
                            + dataset.nidxs[q], tpl):
            assert isinstance(img, CachedImageRef)
            assert img.key == dataset.cache_key(idx)
            assert img.hw == arrays[dataset.images[idx]].shape[:2]
            assert img.entry is dataset.device_cache.peek(img.key)
    dataset.device_cache.clear()
    resized.clear()
    for q in range(len(dataset)):
        tpl, _ = dataset[q]
        for idx, img in zip([dataset.qidxs[q], dataset.pidxs[q]]
                            + dataset.nidxs[q], tpl):
            assert isinstance(img, np.ndarray)
            np.testing.assert_array_equal(img, arrays[dataset.images[idx]])
    assert len(resized) == len(transformed) == 4 * 4
    dataset.item_transform = None
    tpl, _ = dataset[0]
    assert not any(isinstance(img, CachedImageRef) for img in tpl)
