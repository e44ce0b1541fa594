"""Uniform file readers: tsv/csv (+gz/xz), pkl, h5, lst -- the readers of
``mdir_tpu/data/readers.py`` (reference ``daan/data/file_readers.py``).

Readers are context managers picked by suffix. A ``Selector`` picks the
columns (``keys``) and the rows: every ``partitions``-th row from row
``slice``, up to row ``limit`` of the file. Json-looking cells are decoded.
Opening retries three times with a cubic back-off, then raises naming the
path. h5py is imported by the reader that needs it.

Usage::

    with initialize_file_reader(path, keys=["identifier"]) as reader:
        data = reader.get()   # OrderedDict of columns
"""
import gzip
import json
import lzma
import pickle
import re
import time
from collections import OrderedDict


class Selector:
    """Which columns (``keys``, all if None) and rows a reader returns."""

    def __init__(self, *, slice=0, partitions=1, limit=None, keys=None):
        if not 0 <= slice < partitions:
            raise ValueError("slice %d is not one of %d partitions"
                             % (slice, partitions))
        self.slice = slice
        self.partitions = partitions
        self.limit = limit
        self.keys = keys

    @property
    def slicing(self):
        return slice(self.slice, self.limit, self.partitions)


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


class BaseReader:
    RETRIES = 3

    def __init__(self, path, selector):
        self.path = path
        self.selector = selector
        self.handle = None

    def open(self):
        for attempt in range(self.RETRIES + 1):
            try:
                return self._open()
            except (FileNotFoundError, OSError, EOFError):
                if attempt == self.RETRIES:
                    raise ValueError("Error with path '%s' (try %s)"
                                     % (self.path, attempt + 1))
                time.sleep((attempt + 1) ** 3)

    def _open(self):
        if self.path.endswith(".xz"):
            self.handle = lzma.open(self.path, "rb")
        elif self.path.endswith(".gz"):
            self.handle = gzip.open(self.path, "rb")
        else:
            self.handle = open(self.path, "rb")

    def close(self):
        if self.handle is not None:
            self.handle.close()

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, *exc):
        self.close()

    def _iter_selected_lines(self, handle):
        index = 0
        for line in handle:
            if index % self.selector.partitions == self.selector.slice:
                yield line.decode("utf8").rstrip("\n")
            index += 1
            if self.selector.limit and index >= self.selector.limit:
                break


class TsvReader(BaseReader):
    """Tab- or comma-separated columns under a header line."""

    SUFFIXES = (".tsv", ".tsv.gz", ".tsv.xz", ".csv", ".csv.gz", ".csv.xz")

    def __init__(self, path, selector):
        if not path.endswith(self.SUFFIXES):
            raise ValueError("Suffix of '%s' is not supported" % path)
        super().__init__(path, selector)
        self.separator = "\t" if "tsv" in path.rsplit(".", 2) else ","
        self.header = None

    def open(self):
        super().open()
        self.header = next(self.handle).decode("utf8").strip().split(
            self.separator)

    def get(self):
        cols = self.selector.keys or self.header
        indexes = [self.header.index(c) for c in cols]
        acc = [[] for _ in indexes]
        for line in self._iter_selected_lines(self.handle):
            cells = line.split(self.separator)
            for i, j in enumerate(indexes):
                acc[i].append(_decode_cell(cells[j]))
        return OrderedDict(zip(cols, acc))


class PklReader(BaseReader):
    """A pickled dict of columns."""

    def get(self):
        data = pickle.load(self.handle)
        keys = self.selector.keys or data.keys()
        return OrderedDict((k, data[k][self.selector.slicing]) for k in keys)


class Hdf5Reader(BaseReader):
    """An h5 file of datasets; the ``header`` attribute lists the columns."""

    def _open(self):
        import h5py

        self.handle = h5py.File(self.path, "r")

    def _column(self, key):
        data = self.handle[key][self.selector.slicing]
        if data.dtype == object:
            return [x.decode("utf8") if isinstance(x, bytes) else x
                    for x in data.tolist()]
        return data

    def get(self):
        keys = self.selector.keys
        if keys is None:
            keys = list(self.handle.attrs["header"])
        return OrderedDict((k, self._column(k)) for k in keys)


class LstReader(BaseReader):
    """Plain list files; ``path/to/[a|b].lst`` expands to one column each."""

    def __init__(self, path, selector):
        super().__init__(path, selector)
        hit = re.search(r"\[([a-zA-Z0-9_|]+)\]", path)
        if not hit:
            self.paths = OrderedDict([("item", path)])
        else:
            names = hit.group(1)
            self.paths = OrderedDict(
                (x, path.replace("[%s]" % names, x)) for x in names.split("|"))

    def _open(self):
        self.handle = {}
        for key, path in self.paths.items():
            self.handle[key] = open(path, "rb")

    def close(self):
        if self.handle:
            for handle in self.handle.values():
                handle.close()

    def _column(self, key):
        return [_decode_cell(line)
                for line in self._iter_selected_lines(self.handle[key])]

    def get(self):
        keys = self.selector.keys or list(self.paths.keys())
        return OrderedDict((k, self._column(k)) for k in keys)


READERS = {
    "tsv": TsvReader,
    "csv": TsvReader,
    "pkl": PklReader,
    "h5": Hdf5Reader,
    "lst": LstReader,
}


def initialize_file_reader(path, **kwargs):
    """A reader for ``path``, picked by its suffix (``.gz``/``.xz`` looks
    at the one before); ``kwargs`` make its ``Selector``."""
    base, suffix = path.rsplit(".", 1)
    if suffix in ("gz", "xz"):
        suffix = base.rsplit(".", 1)[1]
    if suffix not in READERS:
        raise ValueError("Suffix '%s' is not supported ('%s')" % (suffix, path))
    return READERS[suffix](path, Selector(**kwargs))
