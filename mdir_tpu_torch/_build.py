"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions and is compiled on its own
into ``build/mdir_tpu_torch/<hash>/lib<name>.so`` at the repository root, where
the hash covers the source text and the compiler flags. A build writes to a
temporary name and renames it into place, so an interrupted build leaves no
half library and no lock behind. nvcc runs as a subprocess with a time limit;
the builds of several sources start together. ``-Xptxas -v`` reports each
kernel's registers and shared memory; that report is kept beside the library.

The first call of a kernel's wrapper builds its library, so a process that
only calls the wrappers builds everything it needs.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PACKAGE_DIR), "build",
                          "mdir_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600


class Library:
    """A built shared library: its path, the build's seconds (0 when it was
    already built) and the ptxas report of its kernels."""

    def __init__(self, path, seconds, ptxas):
        self.path = path
        self.seconds = seconds
        self.ptxas = ptxas
        self.cdll = None


_LOADED = {}  # name -> Library, one load per process


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc was not found on PATH or in %s" % home)
    return path


def _paths(name):
    source = os.path.join(CSRC_DIR, name + ".cu")
    with open(source, "rb") as handle:
        text = handle.read()
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, digest)
    return (source, os.path.join(out_dir, "lib%s.so" % name),
            os.path.join(out_dir, "lib%s.ptxas.txt" % name))


def build(names):
    """Build the named sources that are not built yet, all nvcc processes at
    once; return {name: Library}. Raises on a failed or timed-out build."""
    return finish(start(names))


def start(names):
    """Start the nvcc processes of the named sources that are not built
    yet, all at once, and return without waiting: ``finish`` of the result
    waits for them."""
    pending = {}
    built = {}
    for name in names:
        source, lib, report = _paths(name)
        if os.path.exists(lib):
            with open(report) as handle:
                built[name] = Library(lib, 0.0, handle.read())
            continue
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        tmp = "%s.tmp%d" % (lib, os.getpid())
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        pending[name] = (proc, tmp, lib, report, time.perf_counter())
    return pending, built


def stop(started):
    """Kill the builds ``start`` began that still run (a caller that fails
    before ``finish``)."""
    for proc, tmp, *_ in started[0].values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
        if os.path.exists(tmp):
            os.remove(tmp)


def finish(started):
    """Wait for the builds ``start`` began; return {name: Library}. Raises
    on a failed or timed-out build."""
    pending, built = started
    errors = []
    for name, (proc, tmp, lib, report, t0) in pending.items():
        try:
            out, err = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            errors.append("nvcc timed out after %d s on %s"
                          % (BUILD_TIMEOUT_S, name))
            continue
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            errors.append("nvcc failed on %s:\n%s"
                          % (name, (out + err)[-4000:]))
            continue
        ptxas = "\n".join(line for line in (out + err).splitlines()
                          if "ptxas" in line)
        with open(report + ".tmp", "w") as handle:
            handle.write(ptxas)
        os.replace(report + ".tmp", report)
        os.replace(tmp, lib)
        built[name] = Library(lib, seconds, ptxas)
    if errors:
        raise RuntimeError("\n".join(errors))
    return built


def load(name):
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LOADED:
        library = build([name])[name]
        library.cdll = ctypes.CDLL(library.path)
        _LOADED[name] = library
    return _LOADED[name]


def sources():
    """Names of every CUDA source of the package."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))
