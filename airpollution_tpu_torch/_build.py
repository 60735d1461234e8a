"""Build, load and count the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled on first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``. Libraries go to ``build/kernels/<hash>/`` at the repository
root, keyed by a hash of every file in ``csrc/`` and of the compiler flags,
so an edited source is rebuilt and an unchanged one is reused. Nothing here
runs when the module is imported.

Each C entry point returns ``cudaGetLastError()`` after its launch; a
``Kernel`` raises when that is not 0, and counts the launches that went
through. While the port's tracing is on (``utils.profiling``), a kernel
also sums the host's ns inside its launches, and loading a library is the
span ``kernel.load`` (counters ``kernel_builds``, ``kernel_loads``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from airpollution_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    return BUILD_ROOT / _digest() / f"lib{Path(source).stem}.so"


def build(sources) -> dict:
    """Compile every missing library of ``sources`` (file names in csrc/),
    one ``nvcc`` each, all started together. Returns seconds per source
    (0.0 for a library that was already built)."""
    started = {}
    times = {}
    for src in sources:
        out = library_path(src)
        if out.exists():
            times[src] = 0.0
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[src] = (proc, tmp, out, time.perf_counter())
    profiling.count("kernel_builds", len(started))
    failures = []
    for src, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        times[src] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return times


class Kernel:
    """One CUDA kernel behind a C entry point per dtype.

    ``launches`` counts the launches that returned no error; callers that
    want to see whether a run went through the kernel set it to 0 before
    the run and read it after. ``host_ns`` sums the host's ns in those
    launches, from the C call through the error check, only while the
    port's tracing is on (``utils.profiling``, which zeroes it at its
    ``reset``). Each dtype's C function is resolved once,
    on its first launch, with its ``argtypes`` set, so that a launch is
    one ctypes call on plain ints (pointers from :func:`pointer`, the
    stream from :func:`current_stream`).
    """

    def __init__(self, name: str, source: str, symbols: dict, argtypes):
        self.name = name
        self.source = source
        self.symbols = symbols  # torch dtype -> C symbol
        self.argtypes = argtypes
        self.launches = 0
        self.host_ns = 0
        self._lib = None
        self._entry = {}  # torch dtype -> resolved C function
        profiling.track_kernel(self)

    def _library(self):
        if self._lib is None:
            with profiling.span("kernel.load"):
                build([self.source])
                lib = ctypes.CDLL(str(library_path(self.source)))
                profiling.count("kernel_loads")
            lib.crbe_error_string.argtypes = [ctypes.c_int]
            lib.crbe_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def _resolve(self, dtype):
        if dtype not in self.symbols:
            raise TypeError(f"{self.name}: no kernel for {dtype}")
        fn = getattr(self._library(), self.symbols[dtype])
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._entry[dtype] = fn
        return fn

    def launch(self, dtype, *args):
        """Call the entry point for ``dtype`` on the current stream; raise
        on a launch error."""
        fn = self._entry.get(dtype)
        if fn is None:
            fn = self._resolve(dtype)
        timed = profiling.is_on()
        t0 = time.perf_counter_ns() if timed else 0
        err = fn(*args)
        if err != 0:
            msg = self._lib.crbe_error_string(err).decode()
            raise RuntimeError(f"{self.name} launch failed: {msg} ({err})")
        self.launches += 1
        if timed:
            self.host_ns += time.perf_counter_ns() - t0


def pointer(t: torch.Tensor | None) -> int | None:
    """Device pointer of a contiguous tensor as an int (a ``c_void_p``
    argument), or None (NULL) for None."""
    if t is None:
        return None
    if not t.is_contiguous():
        raise ValueError("kernel arguments must be contiguous")
    return t.data_ptr()


def current_stream() -> int:
    """The current CUDA stream of the current device, as an int; read
    anew on every call, so that a caller's stream and CUDA-graph capture
    are honoured. The raw handle skips the ``torch.cuda.Stream`` object
    that ``torch.cuda.current_stream()`` builds: 0.34-0.78 µs a read
    against 4.2-7.6 µs on the hosts of an NVIDIA H100 80GB HBM3 (700 W),
    scripts/torch_port_b3_b7_ab.py."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
