"""Reading a ``torch.profiler`` trace in memory.

The traced window is the host span the benchmark records around it
(``torch.profiler.record_function``). Device events are the card's own:
kernels, copies and fills. The device is busy over the union of their
intervals inside the window; an idle gap is a stretch of the window with
none, named by the span of the benchmark and the innermost host operator
that were running at its middle.
"""
import collections

import torch

TOP = 10


def _is_device(event):
    """A kernel, copy or fill: not a span's mirror on the device's
    timeline (``record_function`` puts one there)."""
    return event.device_type == torch.autograd.DeviceType.CUDA \
        and not getattr(event, "is_user_annotation", False)


def _device_total_us(event):
    """Device time of the kernels a host operator and its children
    launched."""
    total = getattr(event, "device_time_total", None)
    return total if total is not None else event.cuda_time_total


def merged(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _innermost(host, t, prefix=None):
    """The shortest host event that runs over time ``t`` (its name starting
    with ``prefix`` if given), or None."""
    best = None
    for name, start, end in host:
        if start <= t <= end and (prefix is None or name.startswith(prefix)) \
                and (best is None or end - start < best[2] - best[1]):
            best = (name, start, end)
    return best


def summarize(events, window_name, span_prefix="bench."):
    """The traced window's device events and the device's busy time.

    ``events`` is the profiler's ``events()``. Returns a dict: ``kernels``
    [(name, start_us, end_us)] inside the window, ``op_device_s`` {host
    operator: device seconds of the kernels its calls inside the window
    and their children launched}, ``busy_s``, ``window_s``, and the
    ``breakdown`` of the result line: the TOP device operations by
    total time and the TOP longest idle gaps, [name, seconds] each."""
    host, device = [], []
    window = None
    for event in events:
        start, end = event.time_range.start, event.time_range.end
        if _is_device(event):
            if not event.name.startswith(span_prefix):
                device.append((event.name, start, end))
        elif event.device_type == torch.autograd.DeviceType.CPU:
            host.append((event.name, start, end, event))
            if event.name == window_name:
                window = (start, end)
    if window is None:
        raise RuntimeError("the trace has no span %r" % window_name)
    w0, w1 = window
    op_device = collections.Counter()
    for name, start, end, event in host:
        if w0 <= start and end <= w1:
            op_device[name] += _device_total_us(event) * 1e-6
    host = [h[:3] for h in host]
    kernels = [(n, max(s, w0), min(e, w1)) for n, s, e in device
               if e > w0 and s < w1]
    busy = merged((s, e) for _, s, e in kernels)
    totals = collections.Counter()
    for name, s, e in kernels:
        totals[name] += (e - s) * 1e-6
    gaps = []
    edge = w0
    for s, e in busy + [[w1, w1]]:
        if s > edge:
            gaps.append(((s - edge) * 1e-6, (edge + s) / 2))
        edge = max(edge, e)
    ops = [h for h in host
           if not h[0].startswith(span_prefix) and h[0] != window_name]
    named = []
    for seconds, mid in sorted(gaps, reverse=True)[:TOP]:
        span = _innermost(host, mid, span_prefix)
        op = _innermost(ops, mid)
        named.append(["%s > %s" % (span[0] if span else "no span",
                                   op[0] if op else "no operator"),
                      seconds])
    return {
        "kernels": kernels,
        "op_device_s": dict(op_device),
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "breakdown": {
            "device_ops": [[n, t] for n, t in totals.most_common(TOP)],
            "idle_gaps": named,
        },
    }


def device_seconds(kernels, match):
    """Total device time of the kernels whose name ``match`` accepts, and
    how many ran."""
    chosen = [(s, e) for name, s, e in kernels if match(name)]
    return sum(e - s for s, e in chosen) * 1e-6, len(chosen)
