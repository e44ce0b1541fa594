"""Histogram matching and gamma equalization of lightness channels.

The port of ``mdir_tpu/ops/histogram.py`` (reference ``functional.py:55-97``):
256-bin histograms over [-0.5/255, 1 + 0.5/255], CDF matching against a
stored reference CDF (``f3d_lab``, a data artifact of the reference; this
package's ``_hist_f3d_lab.npy`` is its own copy of the JAX package's file,
byte for byte) or equalization (``"eq"``), channel-to-channel matching, and
the gamma that makes mean(L ** gamma) hit a target.

The numpy functions are the host transforms' and are exact: the JAX
package's code, with scipy's Newton solver. The torch functions are the
counterparts of the JAX package's in-graph ones: ``histogram_cdf`` and
``interp`` compute in float64 as numpy does, so they keep ``np.histogram``'s
closed last bin and ``np.interp``'s ends and ties, and the gamma solver is
the JAX package's fixed-iteration Newton in the channel's dtype.
"""
import os

import numpy as np
import torch

HISTOGRAM_BINS = np.linspace(-0.00196078431372549, 1.0019607843137255, 257)
HISTOGRAM_CENTERS = np.linspace(0, 1, 256)

_HIST_F3D_LAB = np.load(os.path.join(os.path.dirname(__file__),
                                     "_hist_f3d_lab.npy"))
HISTOGRAM_CDF = {
    "f3d_lab": np.cumsum(_HIST_F3D_LAB),
}


def channel_histogram_matching(chan, histogram):
    """Match a channel's CDF to a named reference CDF, or equalize it
    (``"eq"``)."""
    cdf = np.cumsum(np.histogram(chan, HISTOGRAM_BINS)[0]) / chan.size
    centers = HISTOGRAM_CENTERS
    if histogram == "eq":
        return np.interp(chan, centers, cdf * centers[-1]).astype(np.float32)
    return np.interp(
        chan, centers, np.interp(cdf, HISTOGRAM_CDF[histogram], centers)
    ).astype(np.float32)


def channel2channel_histogram_matching(chan0, chan1):
    """Match chan0's histogram to chan1's."""
    cdf0 = np.cumsum(np.histogram(chan0, HISTOGRAM_BINS)[0]) / chan0.size
    cdf1 = np.cumsum(np.histogram(chan1, HISTOGRAM_BINS)[0]) / chan1.size
    return np.interp(
        chan0, HISTOGRAM_CENTERS, np.interp(cdf0, cdf1, HISTOGRAM_CENTERS)
    ).astype(np.float32)


def channel_gamma_matching(channel, target):
    """The gamma with mean(channel ** gamma) == target (scipy's Newton, tol
    1e-4), clipped to [0.1, 10], applied."""
    import warnings

    import scipy.optimize

    func = lambda gamma: np.mean(np.power(channel, gamma)) - target
    x0 = np.log(target) / np.log(np.mean(channel))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            solution = scipy.optimize.newton(func, x0=x0, tol=1e-4,
                                             maxiter=50)
        except RuntimeError:
            solution = 0.1 if abs(func(0.1)) < abs(func(10)) else 10
    solution = np.clip(solution, 0.1, 10)
    return np.power(channel, solution)


# ---------------------------------------------------------------------------
# torch counterparts
# ---------------------------------------------------------------------------

def histogram_cdf(chan):
    """The channel's 256-bin CDF (float64), as ``np.histogram`` bins it:
    values outside the edges are dropped, the last bin is closed."""
    edges = torch.as_tensor(HISTOGRAM_BINS, device=chan.device)
    x = chan.reshape(-1).to(torch.float64)
    index = torch.bucketize(x, edges, right=True) - 1
    index = torch.where(x == edges[-1], torch.full_like(index, 255), index)
    inside = (index >= 0) & (index < 256)
    hist = torch.bincount(index[inside], minlength=256)
    return torch.cumsum(hist, 0).to(torch.float64) / chan.numel()


def interp(x, xp, fp):
    """``np.interp`` in float64: fp[0] below xp[0], fp[-1] above xp[-1]; at
    a run of equal xp the last of them; an exact hit returns its fp."""
    x = x.to(torch.float64)
    xp = torch.as_tensor(xp, dtype=torch.float64, device=x.device)
    fp = torch.as_tensor(fp, dtype=torch.float64, device=x.device)
    last = xp.numel() - 1
    j = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0, last)
    j1 = torch.clamp(j + 1, max=last)
    dx = xp[j1] - xp[j]
    slope = (fp[j1] - fp[j]) / torch.where(dx == 0, torch.ones_like(dx), dx)
    out = slope * (x - xp[j]) + fp[j]
    out = torch.where((j == last) | (xp[j] == x), fp[j], out)
    out = torch.where(x < xp[0], fp[0], out)
    return torch.where(x > xp[-1], fp[-1], out)


def channel_histogram_matching_torch(chan, histogram):
    cdf = histogram_cdf(chan)
    centers = torch.as_tensor(HISTOGRAM_CENTERS, device=chan.device)
    if histogram == "eq":
        return interp(chan, centers, cdf * centers[-1]).to(torch.float32)
    mapped = interp(cdf, HISTOGRAM_CDF[histogram], centers)
    return interp(chan, centers, mapped).to(torch.float32)


def channel2channel_histogram_matching_torch(chan0, chan1):
    centers = torch.as_tensor(HISTOGRAM_CENTERS, device=chan0.device)
    mapped = interp(histogram_cdf(chan0), histogram_cdf(chan1), centers)
    return interp(chan0, centers, mapped).to(torch.float32)


def channel_gamma_matching_torch(channel, target, iters=25):
    """The fixed-iteration Newton of the JAX package: 25 steps from
    log(target) / log(mean), each clipped to [0.05, 20], then [0.1, 10]."""
    positive = channel > 0
    logc = torch.where(positive, torch.log(torch.clamp(channel, min=1e-30)),
                       torch.zeros_like(channel))
    gamma = torch.log(torch.tensor(target, dtype=channel.dtype,
                                   device=channel.device)) \
        / torch.log(torch.clamp(torch.mean(channel), min=1e-30))
    gamma = torch.clamp(gamma, 0.05, 20.0)
    for _ in range(iters):
        powed = torch.pow(channel, gamma)
        f = torch.mean(powed) - target
        fprime = torch.mean(powed * logc)
        fprime = torch.where(torch.abs(fprime) < 1e-12,
                             torch.full_like(fprime, 1e-12), fprime)
        gamma = torch.clamp(gamma - f / fprime, 0.05, 20.0)
    return torch.pow(channel, torch.clamp(gamma, 0.1, 10.0))
