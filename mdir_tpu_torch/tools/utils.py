"""Small shared helpers: data root, parameter merging, paths."""
import copy
import os


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
