"""The tsv/csv reader of the eval datasets (optionally .gz/.xz), with column
selection and json cell decoding, as ``mdir_tpu/data/readers.py``.

Usage::

    with initialize_file_reader(path, keys=["identifier"]) as reader:
        data = reader.get()   # OrderedDict of columns
"""
import gzip
import json
import lzma
from collections import OrderedDict


def _decode_cell(value):
    """Decode json-looking cells into collections; empty string -> None."""
    if isinstance(value, str) and not value:
        return None
    if isinstance(value, str) and value[0] in "[{" and value[-1] in "]}":
        try:
            return json.loads(value)
        except json.JSONDecodeError:
            return value
    return value


class TsvReader:
    SUFFIXES = (".tsv", ".tsv.gz", ".tsv.xz", ".csv", ".csv.gz", ".csv.xz")

    def __init__(self, path, keys=None):
        if not path.endswith(self.SUFFIXES):
            raise ValueError("Suffix of '%s' is not supported" % path)
        self.path = path
        self.keys = keys
        self.separator = "\t" if "tsv" in path.rsplit(".", 2) else ","
        self.handle = None
        self.header = None

    def __enter__(self):
        if self.path.endswith(".xz"):
            self.handle = lzma.open(self.path, "rb")
        elif self.path.endswith(".gz"):
            self.handle = gzip.open(self.path, "rb")
        else:
            self.handle = open(self.path, "rb")
        self.header = next(self.handle).decode("utf8").strip().split(
            self.separator)
        return self

    def __exit__(self, *exc):
        self.handle.close()

    def get(self):
        cols = self.keys or self.header
        indexes = [self.header.index(c) for c in cols]
        acc = [[] for _ in indexes]
        for line in self.handle:
            cells = line.decode("utf8").rstrip("\n").split(self.separator)
            for i, j in enumerate(indexes):
                acc[i].append(_decode_cell(cells[j]))
        return OrderedDict(zip(cols, acc))


def initialize_file_reader(path, keys=None):
    """A reader for ``path``, reading the columns ``keys`` (all if None)."""
    return TsvReader(path, keys)
