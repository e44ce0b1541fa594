"""Small shared helpers: data root, parameter merging, paths and the
artifact hash check."""
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
