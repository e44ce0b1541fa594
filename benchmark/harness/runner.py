"""One run of one cell: the harness's result turned into the result line.

``execute`` runs the cell's harness on a device and builds the JSON object
that ``run.py`` prints last: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``trace`` its per-layer
metrics, each read by its own reader), ``device``, with ``trace`` the
``breakdown``, and last ``compare``: each number compared with its limit.
"""
import sys

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "mdir_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is one the run must not load,
    compared whole (``mdir_tpu_torch`` is not ``mdir_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def compare(numbers, limits):
    """``correct``, ``failed`` and ``compared`` {name: (value, limit)} of
    the numbers read, each against its limit (a count such as
    ``nonfinite`` against 0)."""
    compared = {name: (value, limits.get(name, 0))
                for name, value in numbers.items()}
    failed = [name for name, (v, lim) in compared.items() if not v <= lim]
    return {"correct": bool(compared) and not failed,
            "failed": len(failed) + int(numbers.get("nonfinite", 0)),
            "compared": compared}


def execute(registry, workload, seed, seconds, trace, device, started):
    cell = registry.workload(workload)
    config = registry.config(cell["config"])
    mix = registry.mix(cell["traffic"])
    loop = registry.harness(mix)
    result = loop.run(cell, config, mix, seed, seconds, trace, device,
                      started)
    metrics = {}
    if trace:
        for entry in registry.metrics_of(cell, "per_layer"):
            value = registry.reader(entry["name"])(result["layer_ctx"])
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    else:
        for entry in registry.metrics_of(cell, "end_to_end"):
            metrics[entry["name"]] = {
                "value": result["end_to_end"][entry["name"]],
                "unit": entry["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": result["peak_bytes"]}
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = result["trace"]["busy_s"]
        dev["window_s"] = result["trace"]["window_s"]
        line["breakdown"] = result["trace"]["breakdown"]
    line["compare"] = {name: {"value": value, "limit": limit}
                       for name, (value, limit) in result["compared"].items()}
    return line
