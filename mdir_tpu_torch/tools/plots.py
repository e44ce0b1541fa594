"""Plot renderers for reports: curves, percentile-band distributions, and
ridgeline histogram stacks.

The port of ``mdir_tpu/tools/plots.py`` (reference ``mdir/tools/plots.py``),
used by the html report (``tools/htmlreport.py``).
matplotlib imports lazily; all functions draw into a provided Axes.
"""
import numpy as np


def plot_curve(data, ax):
    """data: [(x, y), ...] epoch series."""
    import matplotlib

    if len(data) == 1:
        ax.plot(*zip(*data), marker=".")
        ax.set_xticks([data[0][0]])
    else:
        ax.plot(*zip(*data))
        ax.xaxis.set_major_locator(matplotlib.ticker.MaxNLocator(integer=True))
    ax.spines["right"].set_visible(False)
    ax.spines["top"].set_visible(False)


PERCENTILES = [0, 0.07, 0.16, 0.31, 0.5, 0.69, 0.84, 0.93, 1]
GRID_COLOR = (0.7, 0.7, 0.7)
BAND_COLOR = (1, 165 / 255, 115 / 255)
BOLD_COLOR = (226 / 255, 115 / 255, 70 / 255)


def plot_distribution(histograms, ax):
    """histograms: [(x, bin_centers, counts), ...] -> percentile bands
    over x."""
    import matplotlib

    for side in ("top", "right", "left", "bottom"):
        ax.spines[side].set_visible(False)
    ax.grid(True)
    ax.xaxis.set_major_locator(matplotlib.ticker.MaxNLocator(integer=True))

    if not histograms:
        return
    if len(histograms) == 1:
        x = histograms[0][0]
        ax.set_xticks([x])
        ax.set_xlim(x - 0.01, x + 0.01)
        histograms = [(x - 0.001,) + tuple(histograms[0][1:]),
                      (x + 0.001,) + tuple(histograms[0][1:])]

    xlabels = []
    percentiles = []
    for hist in histograms:
        xlabels.append(hist[0])
        counts = np.asarray(hist[2], dtype=np.float64)
        perc = np.interp(np.array(PERCENTILES) * counts.sum(),
                         np.cumsum(counts), hist[1])
        percentiles.append(perc)
    percentiles = list(zip(*percentiles))

    for i in range(len(percentiles) // 2):
        if i % 2 == 0:
            ax.plot(xlabels, percentiles[i], color=BAND_COLOR)
            ax.plot(xlabels, percentiles[-i - 1], color=BAND_COLOR)
        else:
            color = BAND_COLOR if i <= 1 else BOLD_COLOR
            ax.fill_between(xlabels, percentiles[i], percentiles[-i - 1],
                            color=color + (0.4,))
            ax.plot(xlabels, percentiles[i], color=BOLD_COLOR, linewidth=1)
            ax.plot(xlabels, percentiles[-i - 1], color=BOLD_COLOR,
                    linewidth=1)
    ax.plot(xlabels, percentiles[len(percentiles) // 2], color=BOLD_COLOR)


def plot_histogram(histograms, ax):
    """Ridgeline stack of (label, bin_centers, counts) histograms."""
    n_yticks = 3
    n_ylines_max = 30
    tick_color = GRID_COLOR
    curve_color = (1, 1, 1, 0.4)
    cmap = lambda t: ((200 + 55 * t) / 255, (65 + 100 * t) / 255,
                      (25 + 90 * t) / 255)

    ax.yaxis.tick_right()
    ax.set_ylim(0, 2)
    for side in ("top", "right", "left"):
        ax.spines[side].set_visible(False)
    ax.spines["bottom"].set_linewidth(0.5)
    ax.spines["bottom"].set_color(tick_color)
    ax.xaxis.set_tick_params(width=0.5, colors=tick_color)
    ax.yaxis.set_tick_params(width=0.5, colors=tick_color)

    if not histograms:
        ax.set_xticks([])
        ax.set_yticks([])
        return

    nhists = len(histograms)
    max_y = max(np.max(x[2]) for x in histograms)

    ticks = []
    for i, hist in enumerate(histograms):
        offset = 0 if nhists == 1 else (nhists - i - 1) / (nhists - 1)
        ticks.append((offset, hist[0]))
        ax.fill_between(hist[1], offset, np.asarray(hist[2]) / max_y + offset,
                        facecolor=cmap(i / nhists), edgecolor=curve_color,
                        zorder=2)

    if len(ticks) > 1:
        n_ylines = nhists // max(nhists // n_ylines_max, 1)
        ticks = sorted(ticks[int(i / (n_ylines - 1) * (len(ticks) - 1))]
                       for i in range(n_ylines))
    for offset, _ in ticks:
        ax.axhline(offset, color=tick_color, linewidth=0.5, zorder=1)

    if len(ticks) > 1:
        count = len(ticks) if len(ticks) < 2 * n_yticks - 1 else n_yticks
        ticks = sorted(ticks[int(i / (count - 1) * (len(ticks) - 1))]
                       for i in range(count))
    ax.set_yticks([t[0] for t in ticks])
    ax.set_yticklabels([t[1] for t in ticks])
