"""The traffic generator ``retrieval_tuples``: a retrieval-SfM-like training
database for cirtorch's contrastive training with hard-negative mining.

``clusters`` clusters of ``views`` images each, every image a cut of its
cluster's colour field; their shapes are ``shapes`` (``[height, width,
count]``, the longer side at most the mix's ``image_size``, so the loader
serves them as they are). Every seed gets the same set of shapes; the seed
draws which image gets which shape and where each is cut. The query pool
pairs every view of a cluster with the next one (query, positive), as the
SfM database pairs images of one 3D model.
"""
import numpy as np


def generate(mix, seed):
    rng = np.random.default_rng(seed)
    clusters, views = int(mix["clusters"]), int(mix["views"])
    shapes = [(int(h), int(w)) for h, w, n in mix["shapes"]
              for _ in range(int(n))]
    if len(shapes) != clusters * views:
        raise ValueError("the mix's shapes count %d images, not %d"
                         % (len(shapes), clusters * views))
    shapes = [shapes[i] for i in rng.permutation(len(shapes))]
    field = max(max(hw) for hw in shapes) + int(mix["margin"])
    images = []
    for i, hw in enumerate(shapes):
        images.append({"name": "im%06d.png" % i, "hw": hw,
                       "template": i // views,
                       "offset": (int(rng.integers(0, field - hw[0] + 1)),
                                  int(rng.integers(0, field - hw[1] + 1)))})
    qidxs, pidxs = [], []
    for c in range(clusters):
        for v in range(views - 1):
            qidxs.append(c * views + v)
            pidxs.append(c * views + v + 1)
    return {"images": images, "cluster": [i // views
                                          for i in range(len(images))],
            "qidxs": qidxs, "pidxs": pidxs, "templates": clusters,
            "field": field, "noise": float(mix["noise"])}
