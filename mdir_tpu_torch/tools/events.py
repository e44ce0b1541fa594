"""Event logs: the event broker of the train and validate stages, the
port's copy of ``mdir_tpu/tools/events.py``.

Rows of an epoch are collected (``EpochLog``), merged per key at the
epoch's close, and reduced into per-epoch metric series
(``MetadataKeeper``): a row logged once keeps its value under
``<key>:<subkey>``; per-iteration and list values become
``<key>:<subkey>_avg.4`` (the mean over the non-NaN rows), times
``_sum.1``. Only ``scalar/loss`` and ``scalar/score`` series are metrics.
Rows with no epoch are constants (``ConstLog``, the network's graph). The
broker's state (processors, data root, constants, epochs) round-trips
through the training checkpoint.

Besides scalars the broker takes ``weight/param`` and ``weight/grad`` rows,
kept as 200-bin histograms (bin centres and counts), and ``blob`` rows
(image samples), written under ``<data root>/blobs`` by ``BlobVault`` and
kept as their paths. Processors: ``progress`` (a printer on stderr),
``tensorboard`` (tensorboardX; without it a warning and nothing written)
and ``htmlreport`` (``tools/htmlreport.py``, matplotlib).

Two differences of transport from the JAX package, whose results are the
same: a weight histogram is counted where the tensor lives, on the card in
training, by numpy's bin rule in the tensor's dtype
(``histogram_counts``), so only the 200 counts and centres reach the host;
and PNG blobs are written by the standard library's zlib (``encode_png``)
where the JAX package calls PIL, which the card's machine does not have.
tensorboardX, matplotlib and PIL are imported only where they are used.
"""
import pickle
import struct
import sys
import time
import warnings
import zlib
from pathlib import Path

import numpy as np
import torch

SCALAR_DTYPES = {"scalar/loss", "scalar/score", "scalar/time"}
METRIC_DTYPES = {"scalar/loss", "scalar/score"}
WEIGHT_DTYPES = {"weight/param", "weight/grad"}
EVENT_DTYPES = SCALAR_DTYPES | WEIGHT_DTYPES | {"blob"}
HISTOGRAM_BINS = 200


def histogram_counts(tensor, bins=HISTOGRAM_BINS):
    """``np.histogram(tensor, bins)`` of a torch tensor, counted on its
    device: numpy's edges (``np.linspace`` between the min and max, in the
    tensor's dtype; a constant tensor's range widened by 0.5 each way) and
    its bin rule (the scaled index, corrected by one against the edges; the
    last bin closed). Float32 and float64 tensors are binned in their own
    dtype, as numpy bins them, integer ones in float64, as numpy does, and
    16-bit floats in float32. Returns (edges, counts) as numpy arrays."""
    t = tensor.detach().reshape(-1)
    if not t.dtype.is_floating_point:
        t = t.to(torch.float64)
    elif t.dtype not in (torch.float32, torch.float64):
        t = t.to(torch.float32)
    np_dtype = np.float32 if t.dtype == torch.float32 else np.float64
    lo, hi = (np_dtype(v.item()) for v in torch.aminmax(t))
    if not (np.isfinite(lo) and np.isfinite(hi)):
        raise ValueError("autodetected range of [%s, %s] is not finite"
                         % (lo, hi))
    if lo == hi:
        lo, hi = lo - np_dtype(0.5), hi + np_dtype(0.5)
    edges = np.linspace(lo, hi, bins + 1, endpoint=True, dtype=np_dtype)
    edges_t = torch.from_numpy(edges).to(t.device)
    # a device tensor, not a host scalar: CUDA divides by a host scalar as
    # a product with its reciprocal, one rounding away from numpy's
    denom = torch.from_numpy(np.asarray([hi - lo], np_dtype)).to(t.device)
    index = ((t - edges_t[0]) / denom * bins).to(torch.int64)
    index = index - (index == bins).to(torch.int64)
    index = index - (t < edges_t[index]).to(torch.int64)
    index = index + ((t >= edges_t[index + 1])
                     & (index != bins - 1)).to(torch.int64)
    counts = torch.bincount(index, minlength=bins)
    return edges, counts.cpu().numpy()


def _histogram(values):
    """Weight values (a tensor, counted on its device, or an array) ->
    (bin centres, counts)."""
    if not torch.is_tensor(values):
        values = torch.from_numpy(np.ascontiguousarray(values))
    edges, counts = histogram_counts(values)
    return (edges[:-1] + edges[1:]) / 2, counts


def _png_chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data \
        + struct.pack(">I", zlib.crc32(kind + data) & 0xffffffff)


#: channels -> PNG colour type: gray, gray + alpha, RGB, RGBA
_PNG_COLOUR = {1: 0, 2: 4, 3: 2, 4: 6}


def encode_png(array):
    """An 8-bit (H, W) or (H, W, C) uint8 array (C of 1 to 4) as PNG bytes,
    with the standard library only (each row unfiltered, zlib level 6)."""
    array = np.asarray(array)
    if array.dtype != np.uint8:
        raise ValueError("PNG blobs are 8-bit, got %s" % array.dtype)
    if array.ndim == 2:
        array = array[..., None]
    h, w, c = array.shape
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOUR[c], 0, 0, 0)
    rows = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0 per row
    rows[:, 1:] = array.reshape(h, w * c)
    return b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header) \
        + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) \
        + _png_chunk(b"IEND", b"")


class _Series:
    """One metric curve: the per-epoch reduced values of a key:subkey."""

    def __init__(self, label, dtype, mode):
        self.label = label  # the public name with its aggregation suffix
        self.dtype = dtype
        self.mode = mode  # "avg" | "sum" | None (the raw value)
        self.epochs = []
        self.values = []
        self.density = []

    def record(self, epoch, raw, density):
        if self.mode is None:
            value, density = np.array(raw), None
        else:
            arr = np.asarray(raw, dtype=np.float64)
            arr = arr[~np.isnan(arr)]
            value = float(arr.mean() if self.mode == "avg" else arr.sum())
        self.epochs.append(epoch)
        self.values.append(value)
        self.density.append(density)

    @property
    def higher_is_better(self):
        return self.dtype == "scalar/score"

    def best_position(self):
        pick = np.argmax if self.higher_is_better else np.argmin
        return int(pick(self.values))

    def last_is_best(self):
        edge = max(self.values) if self.higher_is_better \
            else min(self.values)
        return edge == self.values[-1]


class MetadataKeeper:
    """Metric curves over epochs, with best-epoch and coverage reports."""

    aggregations = {"avg": "_avg.4", "sum": "_sum.1", None: ""}

    def __init__(self):
        self.epochs = []
        self._series = {}  # (key, subkey) -> _Series
        self._subkeys = {}  # key -> its subkeys

    def load_epochs_data(self, epochs, consts):
        assert not self._series
        for i, data in enumerate(epochs):
            self.register_epoch_data(i, data, consts)
        return self

    def _discover(self, key, item):
        if key in self._subkeys:
            assert self._subkeys[key] == item["data"].keys()
            return
        self._subkeys[key] = item["data"].keys()
        if not item["dtype"].startswith("scalar/"):
            return
        for subkey, sample in item["data"].items():
            if isinstance(sample, (list, np.ndarray)):
                mode = "avg" if item["dtype"] != "scalar/time" else "sum"
            else:
                mode = None
            label = key + ":" + subkey + self.aggregations[mode]
            self._series[key, subkey] = _Series(label, item["dtype"], mode)

    def register_epoch_data(self, epoch, data, consts=None):
        assert epoch >= 0
        self.epochs.append(epoch)
        for key, item in data.items():
            self._discover(key, item)
        for (key, subkey), series in self._series.items():
            if key not in data:
                continue
            row = data[key]
            density = None
            if row["relative_iteration"] is not None:
                density = len(row["relative_iteration"]) / row["epoch_size"]
            series.record(epoch, row["data"][subkey], density)

    def _lookup(self, key):
        if isinstance(key, str):
            key = tuple(key.split(":"))
        return key, self._series.get(key)

    def metric(self, data_key, item_key):
        return self._series[data_key, item_key].values

    def metadata(self):
        return {s.label: s.values for s in self._series.values()
                if s.dtype in METRIC_DTYPES}

    def is_last_best(self, key):
        key, series = self._lookup(key)
        if key == ("epoch",):
            return True
        if series is None or series.epochs[-1] != self.epochs[-1]:
            return False
        return series.last_is_best()

    def best_epoch(self, key):
        key, series = self._lookup(key)
        if key == ("epoch",):
            return {"index": self.epochs[-1], "metric_avg.3": self.epochs[-1],
                    "key": "epoch"}
        if series is None:
            return None
        pos = series.best_position()
        return {"index": series.epochs[pos],
                "metric_avg.3": series.values[pos], "key": series.label}

    def errors(self):
        """Epoch sequence, iteration coverage and epoch coverage faults."""
        report = []
        if self.epochs != list(range(len(self.epochs))):
            report.append({"message": "Non-standard epoch sequence used",
                           "data": self.epochs})
        partial = {}
        for series in self._series.values():
            for epoch, density in zip(series.epochs, series.density):
                if density is not None and density != 1:
                    partial["%s@epoch_%s" % (series.label, epoch)] = density
        if partial:
            report.append({"message":
                           "Some keys have incomplete iteration coverage",
                           "data": partial})
        gaps = {s.label: s.epochs for s in self._series.values()
                if s.epochs != self.epochs}
        if gaps:
            report.append({"message":
                           "Some keys have incomplete epoch coverage",
                           "data": gaps})
        return report


class BlobVault:
    """Blob files under ``<data root>/blobs``: ``store`` replaces each
    ``{subkey: {"dtype", "data"}}`` entry's ``data`` by the ``path`` it was
    written to (None without a data root)."""

    folder_name = "blobs"
    suffixes = {"image:rgb": "png", "image:rgba": "png", "image:gray": "png",
                "response": "tiff", "vector": "pkl"}

    def __init__(self, dataroot):
        self.root = Path(dataroot) / self.folder_name if dataroot else None
        self._ready = False

    def store(self, key, payload, tag):
        if self.root is None:
            for entry in payload.values():
                entry.pop("data", None)
                entry["path"] = None
            return payload
        if not self._ready:
            self.root.mkdir(parents=True, exist_ok=True)
            self._ready = True
        for subkey, entry in payload.items():
            suffix = self.suffixes[entry["dtype"]]
            fname = "%s:%s:%s.%s" % (key.replace("/", "_"),
                                     subkey.replace("/", "_"), tag, suffix)
            path = self.root / fname
            self._encode(entry.pop("data"), path, suffix)
            entry["path"] = str(path)
        return payload

    @staticmethod
    def _encode(blob, path, suffix):
        if torch.is_tensor(blob):
            blob = blob.detach().cpu().numpy()
        blob = np.asarray(blob)
        if blob.ndim == 3 and blob.shape[-1] == 1:
            blob = blob[..., 0]
        if suffix == "pkl":
            with path.open("wb") as handle:
                pickle.dump(blob, handle)
            return
        if suffix == "png":
            if blob.dtype in (np.float32, np.float64):
                blob = blob * 255
            if blob.dtype != np.uint8:
                blob = np.clip(blob, 0, 255).astype(np.uint8)
            assert blob.ndim in {2, 3}, blob.shape
            path.write_bytes(encode_png(blob))
            return
        from PIL import Image

        assert blob.ndim == 2, blob.shape
        Image.fromarray(blob).save(str(path), format="TIFF")


class EpochLog:
    """One epoch's rows; ``aggregate`` merges them per key."""

    def __init__(self, vault):
        self.vault = vault
        self.epoch = None
        self.rows = []

    def add_row(self, epoch, timestamp, relative_iteration, epoch_size, key,
                data, dtype):
        assert epoch >= 0
        assert isinstance(data, dict), type(data)
        assert dtype in EVENT_DTYPES, dtype
        if dtype == "blob":
            tag = "%s:%s" % (epoch, "null" if relative_iteration is None
                             else relative_iteration)
            data = self.vault.store(key, data, tag)
        elif dtype in WEIGHT_DTYPES:
            data = {subkey: _histogram(values)
                    for subkey, values in data.items()}
        if self.epoch is None:
            self.epoch = epoch
        elif self.epoch != "error" and self.epoch != epoch:
            warnings.warn("inconsistent epoch (%s != %s)"
                          % (epoch, self.epoch))
            self.epoch = "error"
        self.rows.append({
            "timestamp": timestamp, "relative_iteration": relative_iteration,
            "epoch_size": epoch_size, "key": key, "data": data,
            "dtype": dtype})

    def aggregate(self):
        singles, streams = {}, {}
        for row in self.rows:
            if row["relative_iteration"] is None:
                assert row["key"] not in singles
                singles[row["key"]] = row
            else:
                streams.setdefault(row["key"], []).append(row)

        merged = {}
        for key, rows in streams.items():
            head = rows[0]
            subkeys = head["data"].keys()
            for row in rows[1:]:
                assert row["dtype"] == head["dtype"]
                assert row["epoch_size"] == head["epoch_size"]
                assert row["data"].keys() == subkeys
            scalar = head["dtype"].startswith("scalar/")
            columns = {}
            for subkey in subkeys:
                column = [row["data"][subkey] for row in rows]
                columns[subkey] = np.array(column) if scalar else column
            merged[key] = {
                "dtype": head["dtype"],
                "epoch_size": head["epoch_size"],
                "data": columns,
                "relative_iteration":
                    np.array([row["relative_iteration"] for row in rows]),
                "timestamp": np.array([row["timestamp"] for row in rows]),
            }
        overlap = singles.keys() & merged.keys()
        assert not overlap, overlap
        merged.update(singles)
        return merged


class ConstLog:
    """Epoch-independent constants (the network's graph), one per key: a
    repeated scalar constant must carry the same value."""

    def __init__(self, vault, consts):
        self.vault = vault
        self.consts = consts

    def add_const(self, key, data, dtype):
        assert dtype in EVENT_DTYPES, dtype
        if key in self.consts:
            assert self.consts[key]["dtype"] == dtype
            if dtype not in WEIGHT_DTYPES and dtype != "blob":
                assert self.consts[key]["data"] == data, key
            return
        if dtype == "blob":
            data = self.vault.store(key, data, "const")
        elif dtype in WEIGHT_DTYPES:
            data = {subkey: _histogram(values)
                    for subkey, values in data.items()}
        self.consts[key] = {"dtype": dtype, "data": data}


class DebugPrinter:
    """Progress lines on stderr, with s/batch and min/epoch."""

    def __init__(self, print_each=1, print_each_val=None,
                 key_suffix="learning/loss:total", dataroot=None):
        self.print_each = print_each
        self.print_each_val = print_each_val if print_each_val is not None \
            else print_each
        self.key, _, self.subkey = key_suffix.partition(":")
        self.epoch_start = {}

    def add_row(self, epoch, timestamp, relative_iteration, epoch_size, key,
                data, dtype):
        if not key.endswith(self.key) or relative_iteration is None:
            return
        is_val = key.startswith("val") or "/validation/" in key
        each = self.print_each_val if is_val else self.print_each
        if not each:
            return
        track = self.epoch_start.setdefault(
            (key, epoch), {"start": timestamp, "n": 0})
        track["n"] += 1
        if (relative_iteration + 1) % each \
                and relative_iteration + 1 != epoch_size:
            return
        value = data.get(self.subkey) if isinstance(data, dict) else data
        per_batch = (timestamp - track["start"]) / max(track["n"] - 1, 1)
        sys.stderr.write(
            "\r%s epoch %s %d/%d %s: %s (%.3fs/batch, %.1f min/epoch)\n"
            % (key, epoch, relative_iteration + 1, epoch_size, self.subkey,
               ("%.4f" % value) if isinstance(value, (int, float)) else value,
               per_batch, per_batch * epoch_size / 60))


class Tensorboard:
    """tensorboardX summaries: each iteration's scalars at a per-key step,
    and each epoch's means under ``epoch/``. Without tensorboardX (the
    card's machine) it warns and writes nothing, as the JAX package's."""

    def __init__(self, enabled=True, dataroot=None):
        self.writer = None
        self._steps = {}
        if enabled and dataroot is not None:
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(str(dataroot))
            except ImportError:
                warnings.warn("tensorboardX not available; Tensorboard "
                              "disabled")

    def add_row(self, epoch, timestamp, relative_iteration, epoch_size, key,
                data, dtype):
        if self.writer is None or not dtype.startswith("scalar/") \
                or relative_iteration is None:
            return
        step = self._steps[key] = self._steps.get(key, -1) + 1
        for subkey, value in data.items():
            if isinstance(value, (int, float)):
                self.writer.add_scalar("%s/%s" % (key, subkey), value, step)

    def register_epoch_data(self, epoch, data, consts):
        if self.writer is None:
            return
        for key, item in data.items():
            if not item["dtype"].startswith("scalar/"):
                continue
            for subkey, values in item["data"].items():
                arr = np.asarray(values, dtype=np.float64)
                if arr.ndim == 0:
                    self.writer.add_scalar("epoch/%s/%s" % (key, subkey),
                                           float(arr), epoch)
                elif arr.size:
                    self.writer.add_scalar("epoch/%s/%s" % (key, subkey),
                                           float(np.nanmean(arr)), epoch)

    def load_epochs_data(self, epochs, consts):
        for i, data in enumerate(epochs):
            self.register_epoch_data(i, data, consts)
        return self


EVENTPROCESSORS = {
    "progress": DebugPrinter,
    "tensorboard": Tensorboard,
}


def _register_html_report():
    """The html report draws with matplotlib: registered on first use."""
    from .htmlreport import HtmlReport

    EVENTPROCESSORS["htmlreport"] = HtmlReport


class EventBroker:
    """Routes rows to the streamers (``add_row``) and, at an epoch's close,
    the merged epoch to the sinks (``register_epoch_data``); keeps the
    epochs' data, the constants and the metric curves."""

    def __init__(self, processors, dataroot, consts, data):
        self.params = {"processors": processors, "dataroot": dataroot}
        self.data = data
        vault = BlobVault(dataroot)
        self.epoch_log = EpochLog(vault)
        self.const_log = ConstLog(vault, consts)
        self.metadata = MetadataKeeper().load_epochs_data(data, consts)
        self.streamers = []
        self.sinks = []
        if "htmlreport" in processors:
            _register_html_report()
        for name, options in processors.items():
            cls = EVENTPROCESSORS[name]
            proc = cls(**options, dataroot=dataroot) \
                if isinstance(options, dict) \
                else cls(options, dataroot=dataroot)
            if hasattr(proc, "add_row"):
                self.streamers.append(proc)
            if hasattr(proc, "register_epoch_data"):
                self.sinks.append(proc.load_epochs_data(data, consts))

    @classmethod
    def initialize(cls, processors, dataroot):
        return cls(processors, dataroot, {}, [])

    def register_data(self, epoch, relative_iteration, epoch_size, key, data,
                      dtype):
        """One row of an epoch, or with ``epoch`` None a constant."""
        row = {"epoch": epoch, "timestamp": time.time(),
               "relative_iteration": relative_iteration,
               "epoch_size": epoch_size, "key": key, "data": data,
               "dtype": dtype}
        for streamer in self.streamers:
            streamer.add_row(**row)
        if epoch is None:
            self.const_log.add_const(key=key, data=data, dtype=dtype)
        else:
            self.epoch_log.add_row(**row)

    def close_epoch(self):
        epoch = self.epoch_log.epoch
        assert len(self.data) == epoch, "%s != %s" % (len(self.data), epoch)
        epoch_data = self.epoch_log.aggregate()
        consts = self.const_log.consts
        self.metadata.register_epoch_data(epoch, epoch_data, consts)
        for sink in self.sinks:
            sink.register_epoch_data(epoch, epoch_data, consts)
        self.data.append(epoch_data)
        self.epoch_log = EpochLog(self.epoch_log.vault)

    def state_dict(self):
        return {"name": type(self).__name__, "params": self.params,
                "consts": self.const_log.consts, "data": self.data}

    @classmethod
    def initialize_from_state(cls, state_dict, params):
        """Resume: the processors must match; the data root is the
        resumed run's."""
        if state_dict["name"] != cls.__name__ \
                or params["processors"] != state_dict["params"]["processors"]:
            raise AssertionError(
                "resume event processors mismatch: %s != %s"
                % (state_dict["params"]["processors"], params["processors"]))
        return cls(params["processors"], params["dataroot"],
                   state_dict["consts"], state_dict["data"])


def initialize_processor(params, dataroot=None, state=None):
    """The event broker from its processors (the train stage's ``output:
    learning``), writing under ``dataroot``, or resumed from its
    ``state``."""
    params = dict(params)
    if params.pop("type", "EventBroker") != "EventBroker":
        raise ValueError("the port has one event broker, EventBroker")
    if state is None:
        return EventBroker.initialize(params, dataroot)
    return EventBroker.initialize_from_state(
        state, {"processors": params, "dataroot": dataroot})
