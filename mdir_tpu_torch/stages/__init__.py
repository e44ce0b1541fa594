"""Stage entry points."""
from . import cirtorch_format, infer, train, validate, whiten

__all__ = ["cirtorch_format", "infer", "train", "validate", "whiten"]
