"""The traffic generator ``retrieval_passes``: a mix's parameters and a
seed -> the inputs of a run. (A mix names its generator,
``harness/<generator>.py``, which reads only the mix and the seed.)

Every seed gets the same set of image sizes (the mix fixes their counts and
aspect ratios); the seed draws their order, their templates and where each
is cut from its template's colour field, so two seeds do the same work on
different pixels.

A retrieval evaluation as cirtorch runs one on ROxford-like data.
``database.shapes`` lists ``[height, width, count]``;
``queries`` are cut by a bounding box out of a square source image of side
``queries.source_side``, the box's longer side ``queries.longer_side`` and
its width over height one of ``queries.count`` ratios spread evenly in log
scale over ``queries.aspect_range``. Images of one template are each
other's positives; ``templates`` fields are shared by the whole run.
"""
import math

import numpy as np


def _aspects(count, lo, hi):
    """``count`` width/height ratios at the midpoints of ``count`` equal
    steps of log(ratio) over [lo, hi]."""
    a, b = math.log(lo), math.log(hi)
    return [math.exp(a + (b - a) * (k + 0.5) / count) for k in range(count)]


def box_shape(aspect, longer):
    """(h, w) of a box with width / height ``aspect`` and longer side
    ``longer``."""
    if aspect >= 1:
        return max(int(round(longer / aspect)), 1), longer
    return longer, max(int(round(longer * aspect)), 1)


def generate(mix, seed):
    rng = np.random.default_rng(seed)
    templates = int(mix["templates"])
    shapes = [(int(h), int(w)) for h, w, n in mix["database"]["shapes"]
              for _ in range(int(n))]
    shapes = [shapes[i] for i in rng.permutation(len(shapes))]
    db_templates = rng.permutation(np.arange(len(shapes)) % templates)
    q = mix["queries"]
    side, longer = int(q["source_side"]), int(q["longer_side"])
    aspects = _aspects(int(q["count"]), *q["aspect_range"])
    aspects = [aspects[i] for i in rng.permutation(len(aspects))]
    field = max([side] + [max(hw) for hw in shapes]) + int(mix["margin"])

    def offset(h, w):
        return (int(rng.integers(0, field - h + 1)),
                int(rng.integers(0, field - w + 1)))

    database = [{"name": "db%05d.png" % i, "hw": hw, "template": int(t),
                 "offset": offset(*hw)}
                for i, (hw, t) in enumerate(zip(shapes, db_templates))]
    queries, gnd = [], []
    for k, aspect in enumerate(aspects):
        t = int(rng.integers(0, templates))
        bh, bw = box_shape(aspect, longer)
        y0, x0 = (int(rng.integers(0, side - bh + 1)),
                  int(rng.integers(0, side - bw + 1)))
        queries.append({"name": "q%05d.png" % k, "hw": (side, side),
                        "template": t, "offset": offset(side, side),
                        "bbx": (x0, y0, x0 + bw, y0 + bh)})
        gnd.append({"ok": [i for i, d in enumerate(database)
                           if d["template"] == t], "junk": []})
    return {"database": database, "queries": queries, "gnd": gnd,
            "templates": templates, "field": field,
            "noise": float(mix["noise"])}
