"""Profiling hooks: a ``torch.profiler`` trace and named-lap wall timing
(the port of ``mdir_tpu/tools/profiling.py``).

The JAX package captures an XLA profiler trace; the port's native tool is
``torch.profiler``, whose trace of host operations and, on a card, CUDA
kernels and copies is a Chrome/Perfetto JSON file (open it in
``chrome://tracing`` or ui.perfetto.dev). ``key_averages()`` of the
profiler that ``trace`` yields sums the time by operation.

Usage::

    from mdir_tpu_torch.tools.profiling import trace

    with trace("build/trace", device="cuda") as prof:
        extract_vectors_network(...)
    print(prof.key_averages().table(sort_by="cuda_time_total"))

A device memory profile has no CPU counterpart here: the JAX package's
returns a pprof of host buffers on the CPU, the port's
``device_memory_profile`` raises for a CPU device.
"""
import contextlib
import os
import pickle
import time

import torch

from ..device import resolve_device


@contextlib.contextmanager
def trace(log_dir, device="cuda"):
    """Profile the block and write its trace into ``log_dir`` as
    ``trace_<pid>_<ns>.json``: CPU activity, and CUDA activity when
    ``device`` is a card (synchronised before the profiler stops). Yields
    the profiler; its ``trace_path`` names the file once the block ends."""
    device = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.trace_path = os.path.join(
        log_dir, "trace_%d_%d.json" % (os.getpid(), time.time_ns()))
    prof.export_chrome_trace(prof.trace_path)


@contextlib.contextmanager
def timed(label, sink=None, device="cuda"):
    """Wall-time a block, the card synchronised before the clock stops;
    ``sink`` (default ``print``) gets ``"[label] 1.234s"``."""
    device = resolve_device(device)
    start = time.perf_counter()
    try:
        yield
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        (sink or print)("[%s] %.3fs" % (label, time.perf_counter() - start))


def device_memory_profile(path=None, device="cuda"):
    """The card's memory snapshot (``torch.cuda.memory._snapshot``, the
    pickle that PyTorch's memory viz reads) as bytes, or written to
    ``path`` (returned). Raises ``ValueError`` for a device that is not a
    card: there is no CPU counterpart."""
    if torch.device(device).type != "cuda":
        raise ValueError("no device memory profile on %s: it is a CUDA "
                         "card's allocator snapshot" % (device,))
    device = resolve_device(device)
    data = pickle.dumps(torch.cuda.memory._snapshot(device))
    if path:
        with open(path, "wb") as handle:
            handle.write(data)
        return path
    return data
