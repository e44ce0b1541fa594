"""Event logs: the event broker of the train and validate stages, the
port's copy of ``mdir_tpu/tools/events.py``.

Rows of an epoch are collected (``EpochLog``), merged per key at the
epoch's close, and reduced into per-epoch metric series
(``MetadataKeeper``): a row logged once keeps its value under
``<key>:<subkey>``; per-iteration and list values become
``<key>:<subkey>_avg.4`` (the mean over the non-NaN rows), times
``_sum.1``. Only ``scalar/loss`` and ``scalar/score`` series are metrics.
The keeper has best-epoch lookup, a progress printer writes on stderr, and
the broker's state round-trips through the training checkpoint. It takes
scalar rows only: weight histograms, image samples (blob events),
``tensorboard`` and ``htmlreport`` need tensorboardX, matplotlib or PIL,
which the card's machine does not have, and raise (ROADMAP §1.7).
"""
import sys
import time
import warnings

import numpy as np

NOT_PORTED = "ROADMAP §1.7"
METRIC_DTYPES = {"scalar/loss", "scalar/score"}


def _check_dtype(dtype):
    if dtype != "scalar/time" and dtype not in METRIC_DTYPES:
        raise NotImplementedError(
            "%s events (image samples, weight histograms) feed tensorboard "
            "and the html report, which the port does not have (%s)"
            % (dtype, NOT_PORTED))


class _Series:
    """One metric curve: the per-epoch reduced values of a key:subkey."""

    def __init__(self, label, dtype, mode):
        self.label = label  # the public name with its aggregation suffix
        self.dtype = dtype
        self.mode = mode  # "avg" | "sum" | None (the raw value)
        self.epochs = []
        self.values = []

    def record(self, epoch, raw):
        if self.mode is None:
            value = np.array(raw)
        else:
            arr = np.asarray(raw, dtype=np.float64)
            arr = arr[~np.isnan(arr)]
            value = float(arr.mean() if self.mode == "avg" else arr.sum())
        self.epochs.append(epoch)
        self.values.append(value)

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
    """Metric curves over epochs, with best-epoch lookup."""

    aggregations = {"avg": "_avg.4", "sum": "_sum.1", None: ""}

    def __init__(self):
        self.epochs = []
        self._series = {}  # (key, subkey) -> _Series
        self._subkeys = {}  # key -> its subkeys

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

    def register_epoch_data(self, epoch, data):
        assert epoch >= 0
        self.epochs.append(epoch)
        for key, item in data.items():
            self._discover(key, item)
        for (key, subkey), series in self._series.items():
            if key in data:
                series.record(epoch, data[key]["data"][subkey])

    def _lookup(self, key):
        if isinstance(key, str):
            key = tuple(key.split(":"))
        return key, self._series.get(key)

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


class EpochLog:
    """One epoch's rows; ``aggregate`` merges them per key."""

    def __init__(self):
        self.epoch = None
        self.rows = []

    def add_row(self, epoch, timestamp, relative_iteration, epoch_size, key,
                data, dtype):
        assert epoch >= 0
        assert isinstance(data, dict), type(data)
        _check_dtype(dtype)
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
            columns = {subkey: np.array([row["data"][subkey] for row in rows])
                       for subkey in subkeys}
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


class DebugPrinter:
    """Progress lines on stderr, with s/batch and min/epoch."""

    def __init__(self, print_each=1, print_each_val=None,
                 key_suffix="learning/loss:total"):
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


STREAMERS = {
    "progress": DebugPrinter,
}


class EventBroker:
    """Routes rows to the streamers and the epoch log; keeps the per-epoch
    data and the metric curves."""

    def __init__(self, processors, data):
        self.processors = processors
        self.data = data
        self.epoch_log = EpochLog()
        self.metadata = MetadataKeeper()
        for i, epoch_data in enumerate(data):
            self.metadata.register_epoch_data(i, epoch_data)
        self.streamers = []
        for name, options in processors.items():
            if name not in STREAMERS and options is False:
                continue  # a processor switched off
            if name not in STREAMERS:
                raise NotImplementedError(
                    "event processor %r needs tensorboardX, matplotlib or "
                    "PIL, which the port does not use (%s)"
                    % (name, NOT_PORTED))
            self.streamers.append(
                STREAMERS[name](**options) if isinstance(options, dict)
                else STREAMERS[name](options))

    def register_data(self, epoch, relative_iteration, epoch_size, key, data,
                      dtype):
        """One row of an epoch (the port logs no epoch-independent
        constants: the JAX package's are image blobs)."""
        row = {"epoch": epoch, "timestamp": time.time(),
               "relative_iteration": relative_iteration,
               "epoch_size": epoch_size, "key": key, "data": data,
               "dtype": dtype}
        for streamer in self.streamers:
            streamer.add_row(**row)
        self.epoch_log.add_row(**row)

    def close_epoch(self):
        epoch = self.epoch_log.epoch
        assert len(self.data) == epoch, "%s != %s" % (len(self.data), epoch)
        epoch_data = self.epoch_log.aggregate()
        self.metadata.register_epoch_data(epoch, epoch_data)
        self.data.append(epoch_data)
        self.epoch_log = EpochLog()

    def state_dict(self):
        return {"name": type(self).__name__, "processors": self.processors,
                "data": self.data}


def initialize_processor(params, state=None):
    """The event broker from its processors (the train stage's
    ``output: learning``), or resumed from its ``state`` (the processors
    must match)."""
    params = dict(params)
    if params.pop("type", "EventBroker") != "EventBroker":
        raise ValueError("the port has one event broker, EventBroker")
    if state is None:
        return EventBroker(params, [])
    if state["name"] != EventBroker.__name__ \
            or state["processors"] != params:
        raise AssertionError("resume event processors mismatch: %s != %s"
                             % (state["processors"], params))
    return EventBroker(params, state["data"])
