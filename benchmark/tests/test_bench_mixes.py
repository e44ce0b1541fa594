"""The traffic generator: the same inputs for a seed, other pixels and
order for another seed, the same set of sizes for every seed."""
import numpy as np
import pytest

from harness import retrieval_passes
from harness.registry import Registry

MIXES = ["eval-db", "eval-queries"]


def sizes(traffic):
    db = sorted(tuple(d["hw"]) for d in traffic["database"])
    boxes = sorted((q["bbx"][3] - q["bbx"][1], q["bbx"][2] - q["bbx"][0])
                   for q in traffic["queries"])
    return db, boxes


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_traffic(name):
    mix = Registry().mix(name)
    big = 2 ** 31 + 977
    assert retrieval_passes.generate(mix, big) \
        == retrieval_passes.generate(mix, big)


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_traffic_same_sizes(name):
    mix = Registry().mix(name)
    a, b = (retrieval_passes.generate(mix, s) for s in (11, 12))
    assert a != b
    assert [d["offset"] for d in a["database"]] \
        != [d["offset"] for d in b["database"]]
    assert sizes(a) == sizes(b)


def test_eval_db_shapes_and_boxes():
    mix = Registry().mix("eval-db")
    traffic = retrieval_passes.generate(mix, 5)
    db, boxes = sizes(traffic)
    assert len(db) == 256 and db.count((768, 1024)) == 256
    assert len(boxes) == 4 and all(max(b) == 1024 for b in boxes)
    aspects = sorted(w / h for h, w in boxes)
    assert aspects[0] == pytest.approx(3 ** -0.75, rel=1e-2)
    for q, gnd in zip(traffic["queries"], traffic["gnd"]):
        x0, y0, x1, y1 = q["bbx"]
        assert 0 <= x0 < x1 <= 1024 and 0 <= y0 < y1 <= 1024
        assert gnd["ok"] == [i for i, d in enumerate(traffic["database"])
                             if d["template"] == q["template"]]


def test_eval_queries_spreads_buckets():
    mix = Registry().mix("eval-queries")
    _, boxes = sizes(retrieval_passes.generate(mix, 5))
    buckets = {(-(-h // 64) * 64, -(-w // 64) * 64) for h, w in boxes}
    assert len(boxes) == 64 and len(buckets) >= 20


def test_images_follow_the_seed():
    import torch

    from harness import images

    mix = Registry().mix("eval-queries")
    traffic = retrieval_passes.generate(mix, 3)
    specs = traffic["database"][:2]

    def make(seed):
        gen = torch.Generator().manual_seed(seed)
        colour = images.fields(traffic["templates"], traffic["field"], gen,
                               "cpu")
        return images.render(specs, colour, traffic["noise"], gen)

    a, b, c = make(2 ** 40 + 1), make(2 ** 40 + 1), make(7)
    for spec in specs:
        name = spec["name"]
        assert a[name].dtype == np.uint8
        assert a[name].shape == tuple(spec["hw"]) + (3,)
        assert np.array_equal(a[name], b[name])
        assert not np.array_equal(a[name], c[name])
