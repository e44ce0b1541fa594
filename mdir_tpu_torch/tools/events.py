"""The metric log of the validate stage.

Reduces logged rows to the metric dict of ``mdir_tpu``'s EventBroker
(``MetadataKeeper.metadata()`` after one epoch), with the same keys:

* a row logged once (``iteration`` None), e.g. ``.../score_avg`` -> one
  entry per subkey, ``<key>:<subkey>``, holding the value as a numpy array;
* rows logged per iteration, e.g. ``.../score`` per query -> one entry per
  subkey, ``<key>:<subkey>_avg.4``, holding the mean over the non-NaN rows.

Only ``scalar/loss`` and ``scalar/score`` rows become metrics, as there.
"""
import numpy as np

METRIC_DTYPES = {"scalar/loss", "scalar/score"}


class MetricLog:

    def __init__(self):
        self.singles = {}  # key -> data dict
        self.streams = {}  # key -> [data dict, ...]
        self.dtypes = {}

    def register(self, iteration, _size, key, data, dtype):
        assert isinstance(data, dict), type(data)
        self.dtypes[key] = dtype
        if iteration is None:
            assert key not in self.singles, key
            self.singles[key] = data
        else:
            self.streams.setdefault(key, []).append(data)

    def metrics(self):
        out = {}
        for key, data in self.singles.items():
            if self.dtypes[key] in METRIC_DTYPES:
                for subkey, value in data.items():
                    out["%s:%s" % (key, subkey)] = np.array(value)
        for key, rows in self.streams.items():
            if self.dtypes[key] not in METRIC_DTYPES:
                continue
            for subkey in rows[0]:
                column = np.asarray([row[subkey] for row in rows],
                                    dtype=np.float64)
                column = column[~np.isnan(column)]
                out["%s:%s_avg.4" % (key, subkey)] = float(column.mean())
        return out
