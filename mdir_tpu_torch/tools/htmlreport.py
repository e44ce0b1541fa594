"""The html training report, an event sink: the port of
``mdir_tpu/tools/htmlreport.py`` (reference ``tools/eventprocessor.py:
429-600``). One standalone ``report.html`` under the data root with each
metric's curve, the weight histograms as ridgelines over the epochs and the
latest image samples, figures embedded as base64 PNGs, rendered at every
epoch's close.

The figures are drawn with matplotlib, imported at render time. An enabled
report without matplotlib (the card's machine has none) raises when it is
made, naming it, rather than training an epoch and then failing.
"""
import base64
import html
import io
from pathlib import Path

import numpy as np

from . import plots


def _fig_to_b64(fig):
    import matplotlib.pyplot as plt

    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight", dpi=80)
    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _img_tag(b64, width=360):
    return '<img src="data:image/png;base64,%s" style="max-width:%dpx">' % (
        b64, width)


def _thumb_tag(path, width=200):
    try:
        with open(path, "rb") as handle:
            b64 = base64.b64encode(handle.read()).decode("ascii")
        return _img_tag(b64, width)
    except OSError:
        return "<em>missing blob %s</em>" % html.escape(str(path))


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class HtmlReport:

    def __init__(self, enabled=True, dataroot=None):
        self.enabled = bool(enabled) and dataroot is not None
        if self.enabled:
            try:
                import matplotlib  # noqa: F401
            except ImportError as exc:
                raise ImportError("the htmlreport processor draws with "
                                  "matplotlib, which is not installed") \
                    from exc
        self.dataroot = Path(dataroot) if dataroot is not None else None
        self.epochs = []  # the aggregated data of each epoch
        self.consts = {}

    def load_epochs_data(self, epochs, consts):
        self.epochs = list(epochs)
        self.consts = consts
        return self

    def register_epoch_data(self, epoch, data, consts):
        self.epochs.append(data)
        self.consts = consts
        if self.enabled:
            self.render(epoch)

    def _series(self, dtype_prefix):
        """{key: {subkey: [(epoch, aggregated value or histograms)]}}"""
        acc = {}
        for epoch, data in enumerate(self.epochs):
            for key, item in data.items():
                if not item["dtype"].startswith(dtype_prefix):
                    continue
                for subkey, values in item["data"].items():
                    acc.setdefault(key, {}).setdefault(subkey, []).append(
                        (epoch, values))
        return acc

    def _figure(self, out, key, subkey, draw):
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(4, 2.2))
        draw(ax)
        ax.set_title("%s:%s" % (key, subkey), fontsize=8)
        out.append("<div style='display:inline-block'><small>%s:%s</small>"
                   "<br>%s</div>" % (html.escape(key), html.escape(subkey),
                                     _img_tag(_fig_to_b64(fig))))

    def _render_scalar_curves(self, out):
        for key, subkeys in sorted(self._series("scalar/").items()):
            for subkey, series in sorted(subkeys.items()):
                points = []
                for epoch, values in series:
                    arr = np.asarray(values, dtype=np.float64).ravel()
                    arr = arr[~np.isnan(arr)]
                    if arr.size:
                        points.append((epoch, float(arr.mean())))
                if points:
                    self._figure(out, key, subkey, lambda ax, points=points:
                                 plots.plot_curve(points, ax))

    def _render_weight_hists(self, out):
        for key, subkeys in sorted(self._series("weight/").items()):
            for subkey, series in sorted(subkeys.items()):
                hists = []
                for epoch, values in series:
                    # an epoch's rows: a list of (centres, counts), latest
                    if isinstance(values, list) and values \
                            and isinstance(values[0], (tuple, list)):
                        centers, counts = values[-1]
                    else:
                        centers, counts = values
                    hists.append((epoch, np.asarray(centers),
                                  np.asarray(counts)))
                if hists:
                    self._figure(out, key, subkey, lambda ax, hists=hists:
                                 plots.plot_histogram(hists, ax))

    def _render_blobs(self, out):
        latest = self.epochs[-1] if self.epochs else {}
        for key, item in list(latest.items()) + list(self.consts.items()):
            if item["dtype"] != "blob":
                continue
            out.append("<h3>%s</h3>" % html.escape(key))
            for subkey, value in item["data"].items():
                if isinstance(value, list):  # per-iteration: the latest
                    value = value[-1]
                path = value.get("path")
                if path:
                    out.append("<div><small>%s</small><br>%s</div>"
                               % (html.escape(subkey), _thumb_tag(path)))

    def render(self, epoch):
        out = ["<!DOCTYPE html><html><head><meta charset='utf-8'>"
               "<title>mdir-tpu training report</title>"
               "<style>body{font-family:sans-serif;margin:20px} "
               "img{margin:4px;border:1px solid #ddd}</style></head><body>",
               "<h1>Training report — epoch %s</h1>" % epoch]
        for title, draw in (("Metrics", self._render_scalar_curves),
                            ("Weights", self._render_weight_hists)):
            out.append("<h2>%s</h2>" % title)
            try:
                draw(out)
            except Exception as exc:  # a figure that fails is reported
                out.append("<em>%s unavailable: %s</em>"
                           % (title.lower(), html.escape(str(exc))))
        out.append("<h2>Samples</h2>")
        self._render_blobs(out)
        out.append("</body></html>")
        self.dataroot.mkdir(parents=True, exist_ok=True)
        with open(self.dataroot / "report.html", "w") as handle:
            handle.write("\n".join(out))
