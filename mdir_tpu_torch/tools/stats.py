"""Timing and resource statistics of the train stage, as
``mdir_tpu/tools/stats.py``: a named-lap stopwatch, cumulative resource
usage that survives a resume (device memory from
``torch.cuda.max_memory_allocated`` on a card) and the code version.
"""
import os
import resource
import time

import torch


class StopWatch:
    """Named-lap stopwatch; ``reset`` returns {label: seconds} laps."""

    def __init__(self):
        self.time0 = time.time()
        self.laps = {}
        self._last = self.time0

    def lap(self, label):
        now = time.time()
        self.laps[label] = self.laps.get(label, 0.0) + (now - self._last)
        self._last = now
        return self

    def reset(self, include_total=True):
        laps = self.laps
        if include_total:
            laps = {**laps, "total": time.time() - self.time0}
        self.time0 = time.time()
        self._last = self.time0
        self.laps = {}
        return laps


class ResourceUsage:
    """Cumulative process resource usage, surviving checkpoint resume."""

    def __init__(self, state=None):
        self.state = state or {
            "max_ram_gb": 0.0,
            "max_device_mem_gb": 0.0,
            "cpu_time_s": 0.0,
            "wall_time_s": 0.0,
        }
        self._start_wall = time.time()
        self._start_cpu = time.process_time()

    @classmethod
    def initialize(cls):
        return cls()

    @classmethod
    def initialize_from_state(cls, state):
        return cls(dict(state))

    @staticmethod
    def _device_memory_gb():
        if not torch.cuda.is_available():
            return 0.0
        return torch.cuda.max_memory_allocated() / 1e9

    def take_current_stats(self):
        ram_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        self.state["max_ram_gb"] = round(max(self.state["max_ram_gb"],
                                             ram_gb), 3)
        self.state["max_device_mem_gb"] = round(
            max(self.state["max_device_mem_gb"], self._device_memory_gb()), 3)
        self.state["cpu_time_s"] = round(
            self.state["cpu_time_s"] + time.process_time() - self._start_cpu,
            1)
        self.state["wall_time_s"] = round(
            self.state["wall_time_s"] + time.time() - self._start_wall, 1)
        self._start_wall = time.time()
        self._start_cpu = time.process_time()
        return self

    def get_resources(self):
        return dict(self.state)

    def state_dict(self):
        return dict(self.state)


class CodeVersion:
    """The current git commit, read from .git/HEAD without running git."""

    def __init__(self, root=None):
        self.versions = {"mdir_tpu_torch": self._read_git_head(root)}

    @staticmethod
    def _read_git_head(root=None):
        root = root or os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                    "..", ".."))
        try:
            with open(os.path.join(root, ".git", "HEAD")) as handle:
                head = handle.read().strip()
            if head.startswith("ref:"):
                ref = head.split(" ", 1)[1]
                with open(os.path.join(root, ".git", ref)) as handle:
                    return handle.read().strip()
            return head
        except OSError:
            return "unknown"
