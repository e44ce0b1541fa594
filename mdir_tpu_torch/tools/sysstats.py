"""Device and host statistics (``mdir_tpu/tools/sysstats.py``, reference
``daan/data/sysstats.py``): the card's memory from ``torch.cuda``
(``mem_get_info`` and the caching allocator's ``memory_stats``), the host's
memory and load from ``/proc``."""
import os

import torch


class DeviceStats:
    """The CUDA devices' memory, through ``torch.cuda``."""

    @staticmethod
    def memory_usage():
        """{device: {bytes_in_use, bytes_limit, bytes_reserved,
        peak_bytes_in_use}} of each visible CUDA device (empty without
        one): the allocator's bytes in use and its peak, what it has
        reserved on the device, and the device's total memory."""
        acc = {}
        if not torch.cuda.is_available():
            return acc
        for index in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(index)
            _free, total = torch.cuda.mem_get_info(index)
            acc["cuda:%d" % index] = {
                "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "bytes_limit": total,
                "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak",
                                               0)}
        return acc

    @staticmethod
    def memory_usage_by_pid(pid=None):
        """{pid: bytes}: one process owns this process's devices."""
        pid = pid if pid is not None else os.getpid()
        usage = DeviceStats.memory_usage()
        return {pid: sum(v["bytes_in_use"] or 0 for v in usage.values())}


class HostStats:

    @staticmethod
    def memory_gb():
        """(used, total) host memory in GB from /proc/meminfo."""
        info = {}
        with open("/proc/meminfo") as handle:
            for line in handle:
                key, _, rest = line.partition(":")
                info[key] = int(rest.strip().split()[0])  # kB
        total = info.get("MemTotal", 0) / 1e6
        available = info.get("MemAvailable", 0) / 1e6
        return round(total - available, 2), round(total, 2)

    @staticmethod
    def loadavg():
        with open("/proc/loadavg") as handle:
            return tuple(float(x) for x in handle.read().split()[:3])
