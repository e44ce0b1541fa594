"""The file readers in both packages: each reader (tsv, tsv.gz, tsv.xz, csv,
pkl, h5, lst and the ``[a|b].lst`` column expansion) and each ``Selector``
knob (keys, slice/partitions, limit) reads the same temporary files to the
same columns, exactly."""
import gzip
import lzma
import pickle

import numpy as np
import pytest

from mdir_tpu.data.readers import initialize_file_reader as jax_reader

from mdir_tpu_torch.data.readers import initialize_file_reader

ROWS = 10
TABLE = "id\tvalue\tmeta\n" + "".join(
    "r%d\t%d\t%s\n" % (i, i * i, ["[1, %d]" % i, "{}", "", "x{y"][i % 4])
    for i in range(ROWS))


def _write_tsv(path, opener=open):
    with opener(path, "wt") as handle:
        handle.write(TABLE)


def _write_csv(path):
    path.write_text(TABLE.replace("\t", ","))


def _write_pkl(path):
    with open(path, "wb") as handle:
        pickle.dump({"x": np.arange(ROWS), "y": np.arange(ROWS) * 2.5,
                     "names": ["n%d" % i for i in range(ROWS)]}, handle)


def _write_h5(path):
    import h5py

    with h5py.File(path, "w") as handle:
        handle["col"] = np.arange(ROWS)
        handle["names"] = np.array(["h%d" % i for i in range(ROWS)],
                                   dtype=object).astype("S")
        handle["names_obj"] = np.array(
            ["o%d" % i for i in range(ROWS)],
            dtype=h5py.string_dtype())
        handle.attrs["header"] = ["col", "names_obj"]


def _write_lst(directory):
    (directory / "a.lst").write_text("".join("a%d\n" % i
                                             for i in range(ROWS)))
    (directory / "b.lst").write_text("".join("[%d]\n" % i
                                             for i in range(ROWS)))


CASES = {
    "tsv": ("data.tsv", _write_tsv, {}),
    "tsv_keys": ("data.tsv", _write_tsv, {"keys": ["meta", "id"]}),
    "tsv_gz_partitions": ("data.tsv.gz",
                          lambda p: _write_tsv(p, gzip.open),
                          {"slice": 1, "partitions": 3}),
    "tsv_xz_limit": ("data.tsv.xz", lambda p: _write_tsv(p, lzma.open),
                     {"limit": 4}),
    "csv": ("data.csv", _write_csv, {"keys": ["value"]}),
    "pkl": ("data.pkl", _write_pkl, {}),
    "pkl_keys_limit": ("data.pkl", _write_pkl, {"keys": ["y"], "limit": 4}),
    "pkl_partitions": ("data.pkl", _write_pkl,
                       {"slice": 2, "partitions": 4, "keys": ["names"]}),
    "h5_header": ("data.h5", _write_h5, {}),
    "h5_keys_partitions": ("data.h5", _write_h5,
                           {"keys": ["names", "col"], "slice": 0,
                            "partitions": 2}),
    "h5_limit": ("data.h5", _write_h5, {"keys": ["col"], "limit": 3}),
    "lst": ("a.lst", lambda p: _write_lst(p.parent), {}),
    "lst_columns": ("[a|b].lst", lambda p: _write_lst(p.parent), {}),
    "lst_columns_selected": ("[a|b].lst", lambda p: _write_lst(p.parent),
                             {"keys": ["b"], "slice": 1, "partitions": 2,
                              "limit": 7}),
}


def _plain(columns):
    return {key: value.tolist() if isinstance(value, np.ndarray) else value
            for key, value in columns.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_matches_jax(case, tmp_path):
    name, write, selector = CASES[case]
    path = tmp_path / name
    write(path)
    with initialize_file_reader(str(path), **selector) as reader:
        ours = reader.get()
    with jax_reader(str(path), **selector) as reader:
        theirs = reader.get()
    assert list(ours) == list(theirs) and ours
    for key in ours:
        assert type(ours[key]) is type(theirs[key]), key
    assert _plain(ours) == _plain(theirs)


def test_reader_rejects_what_jax_rejects(tmp_path):
    with pytest.raises(ValueError, match="not supported"):
        initialize_file_reader("foo.xyz")
    with pytest.raises(ValueError, match="partitions"):
        initialize_file_reader(str(tmp_path / "a.tsv"), slice=2,
                               partitions=2)
