#!/usr/bin/env python3
"""Readings that set a cell's limits, on the card at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 12 \
        --control-seeds 3 --fault-seeds 3 [--first-seed N]

In one process: for each of ``--seeds`` seeds one run of the cell with a
window of one pass (the lower readings: every compared number of a sound
run; a train cell's window of one epoch after epoch 0); for the first
``--control-seeds`` of them also the control, the reference with its trunk
in bfloat16 put in the program's place and judged by the cell's limits
(the harness's ``control``); then
each fault of ``harness/faults.py`` that the cell can have on
``--fault-seeds`` seeds. Prints one JSON line per
reading, then a summary: each number's largest sound reading and the
control's and each fault's smallest. Exits 1 where the control or a fault
comes out correct. The benchmark's own runs do not run this.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]

import torch  # noqa: E402

from harness import faults  # noqa: E402
from harness.registry import Registry  # noqa: E402


def readings(registry, workload, seed, device, fault=None, control=False):
    cell = registry.workload(workload)
    config = registry.config(cell["config"])
    mix = registry.mix(cell["traffic"])
    loop = registry.harness(mix)
    t = time.perf_counter()
    planted = faults.FAULTS[mix["harness"]][fault] if fault is not None \
        else contextlib.nullcontext
    with planted():
        out = loop.run(cell, config, mix, seed, 0.0, False, device, t,
                       warmup=False,
                       after=loop.control if control else None)
    line = {"workload": workload, "seed": seed, "fault": fault,
            "correct": out["correct"],
            "compared": {k: v for k, (v, _) in out["compared"].items()},
            "seconds": time.perf_counter() - t}
    if "follows" in out:
        line["follows"] = out["follows"]
    if control:
        line["control"] = out["after"]
    print(json.dumps(line), flush=True)
    return line


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--fault-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=3_000_000_001)
    parser.add_argument("--faults", default=None,
                        help="comma-separated faults (default: all)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("needs a CUDA device\n")
        return 2
    device = torch.device("cuda", 0)
    registry = Registry()
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    sound = [readings(registry, args.workload, s, device,
                      control=k < args.control_seeds)
             for k, s in enumerate(seeds)]
    kind = registry.mix(registry.workload(args.workload)["traffic"])[
        "harness"]
    faulty = {name: [readings(registry, args.workload, s, device, fault=name)
                     for s in seeds[:args.fault_seeds]]
              for name in (args.faults.split(",") if args.faults
                           else faults.FAULTS[kind])}
    controls = [{k: v for k, (v, _) in r["control"]["compared"].items()}
                for r in sound if "control" in r]
    summary = {"workload": args.workload,
               "sound_max": {k: max(r["compared"][k] for r in sound)
                             for k in sound[0]["compared"]},
               "sound_correct": sum(r["correct"] for r in sound),
               "control_min": {k: min(c[k] for c in controls)
                               for k in (controls[0] if controls else {})},
               "control_correct": sum(r["control"]["correct"]
                                      for r in sound if "control" in r),
               "faults_min": {name: {k: min(r["compared"][k] for r in runs)
                                     for k in runs[0]["compared"]}
                              for name, runs in faulty.items()},
               "faults_correct": {name: sum(r["correct"] for r in runs)
                                  for name, runs in faulty.items()},
               "card": torch.cuda.get_device_name(device)}
    print(json.dumps(summary), flush=True)
    return int(bool(summary["control_correct"])
               or any(summary["faults_correct"].values()))


if __name__ == "__main__":
    sys.exit(main())
