"""Small shared helpers: data root, parameter merging, the DSL's tuples,
paths, the artifact hash check and the local file of an artifact URL
(``resolve_artifact``, ``local_path``: every entry that takes a published
file by URL reads it through them)."""
import copy
import hashlib
import os
import re


def get_root():
    """Data root: $MDIR_TPU_ROOT (or cirtorch's $CIRTORCH_ROOT), else the
    repository root -- the same lookup as the JAX package."""
    for var in ("MDIR_TPU_ROOT", "CIRTORCH_ROOT"):
        if os.environ.get(var, ""):
            return os.environ[var]
    return os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def get_data_root():
    return os.path.join(get_root(), "data")


def get_dataset_params(params, net_defaults):
    """Merge network-embedded data defaults under per-dataset params."""
    return copy.deepcopy({**net_defaults, **params})


def parse_tuple(tpl, dtype=int):
    """Parse ``"512_512"``-style underscore tuples of the transform DSL."""
    if isinstance(tpl, str):
        return tuple(dtype(x) for x in tpl.split("_"))
    return tpl


def path_join(prefix, path):
    """Join, letting an absolute ``path`` override the prefix."""
    if path.startswith("/"):
        return path
    return os.path.join(prefix, path)


def validate_hash(content, path):
    """Check ``content`` against the sha256 prefix in a file name of the form
    ``name-<hex prefix>.ext`` (cirtorch's artifact names); other names pass."""
    match = re.search(r".*-([a-f0-9]{8,})\.[a-zA-Z0-9]{2,}$", path)
    if not match:
        return
    stored = match.group(1)
    computed = hashlib.sha256(content).hexdigest()[:len(stored)]
    if computed != stored:
        raise ValueError("Computed hash '%s' is not consistent with stored "
                         "hash '%s'" % (computed, stored))


def resolve_artifact(url, artifacts=None):
    """The local, hash-checked file that stands for ``url``:
    ``<artifacts>/<basename>``, by default ``<data root>/networks/<basename>``
    (where the JAX package caches what it downloads). Nothing is downloaded:
    a missing file raises, naming the path to put it at."""
    directory = artifacts or os.path.join(get_data_root(), "networks")
    path = os.path.join(directory, os.path.basename(url))
    if not os.path.isfile(path):
        raise FileNotFoundError(
            "%s is not on disk and the port does not download: put it at %s"
            % (url, path))
    with open(path, "rb") as handle:
        validate_hash(handle.read(), path)
    return path


def local_path(path, artifacts=None):
    """``path`` itself, or for an ``http(s)://`` URL its local file by
    ``resolve_artifact`` (the JAX package's ``load_url`` into
    ``<data root>/networks``, without the download)."""
    if str(path).startswith(("http://", "https://")):
        return resolve_artifact(str(path), artifacts)
    return path
