#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the repository root, on a machine with the card(s) the cell asks for
(``BENCHMARK.json``). Prints the compared numbers beside their limits as
the last lines of standard error and one JSON object as the last line of
standard output (``harness/runner.py``). Exits non-zero, printing no
result, without a CUDA device, with fewer devices than the cell needs, or
when the process has loaded JAX or the JAX package by the time the window
has closed.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# every build and kernel cache at a fixed place inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
sys.path[:0] = [BENCH_DIR, ROOT]

import torch  # noqa: E402

from harness import runner  # noqa: E402
from harness.registry import Registry  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    registry = Registry()
    chips = registry.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.stderr.write("needs %d CUDA device(s); found %d\n" % (
            chips, torch.cuda.device_count()
            if torch.cuda.is_available() else 0))
        return 2
    line = runner.execute(registry, args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0), STARTED)
    found = runner.forbidden_modules()
    if found:
        sys.stderr.write("the run loaded %s\n" % ", ".join(found))
        return 3
    for name, entry in line["compare"].items():
        sys.stderr.write("compare %s %r limit %r\n"
                         % (name, entry["value"], entry["limit"]))
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
