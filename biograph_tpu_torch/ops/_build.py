"""Builds and loads the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` for ``sm_90a`` into a shared library under
``biograph_tpu_torch/_kernels_build/`` (created here, never committed), then
loaded with ``ctypes``.  No source includes PyTorch's headers, so a build
takes seconds; pointers travel as ``tensor.data_ptr()`` and the stream as
``torch.cuda.current_stream().cuda_stream``.  Every C entry point returns
``cudaGetLastError()`` after its launches; ``launch`` raises on a non-zero
code.  A missing compiler, a failed build or a refused launch raises:
nothing here falls back to another implementation.

This route was taken instead of ``torch.utils.cpp_extension.load`` because
that one compiles against PyTorch's headers, which takes minutes a source.
The build directory lies inside the package, so the package must sit in a
directory its user may write to (a checkout or an editable install).

``build_all`` starts one ``nvcc`` per source at once, so a cold start pays
the slowest single build rather than their sum.

``traced`` marks each kernel wrapper's calls while a profiler runs (a
``runtime.log.maybe_profile`` trace or any other): a launch on the card, or
the plain version on the CPU, is one span of ``runtime.log``'s recorder,
named after the wrapper, and in a ``maybe_profile`` trace one range named
``bgt::<wrapper>``, so the trace names the host side of each launch (the
device side carries the ``__global__`` function's name).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

from biograph_tpu_torch.runtime import log as _log

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_kernels_build")
KERNELS = (
    "rank4", "rank4_tiled", "gather_sizes", "push4", "push_front",
    "chain_window", "rank_cum", "beam_steps", "sequences",
)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_libs: dict = {}
_functions: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built"
    )


def source_path(name: str) -> str:
    return os.path.join(CSRC, name + ".cu")


def _lib_path(name: str) -> str:
    """Named by the source, the headers beside it and the flags, so that a
    change to any of them builds anew."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in (source_path(name), *(os.path.join(CSRC, h) for h in headers)):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start_build(name: str, out: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, cmd


def _finish_build(name, out, proc, tmp, cmd):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{log}"
        )
    os.replace(tmp, out)


def build_all() -> list:
    """Build every kernel that is not built yet, all compilers started
    together.  Returns the names of the kernels it built."""
    with _lock:
        started = []
        for name in KERNELS:
            out = _lib_path(name)
            if not os.path.exists(out):
                started.append((name, out, *_start_build(name, out)))
        for job in started:
            _finish_build(*job)
        return [job[0] for job in started]


def load(name: str) -> ctypes.CDLL:
    """The shared library of one kernel, built first if need be."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        out = _lib_path(name)
        if not os.path.exists(out):
            _finish_build(name, out, *_start_build(name, out))
        lib = ctypes.CDLL(out)
        _libs[name] = lib
    return lib


def function(kernel: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of one kernel's library, returning the
    CUDA error code of its launches."""
    fn = _functions.get(symbol)
    if fn is None:
        fn = getattr(load(kernel), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[symbol] = fn
    return fn


@functools.cache
def check_constants(kernel: str, constants: tuple) -> None:
    """The layout constants a kernel was compiled with are its wrapper's:
    ``constants`` is pairs of (C function returning the constant, the
    wrapper's value), asked of the library once, when it is first loaded."""
    for symbol, value in constants:
        if function(kernel, symbol, [])() != value:
            raise RuntimeError(f"{kernel}: {symbol} differs from the wrapper's")


def launch(kernel: str, symbol: str, argtypes, device, *args):
    """Call a kernel's C entry point on PyTorch's current stream of
    ``device`` (the stream is appended as the last argument) and raise if it
    reports a CUDA error.  Tensors go in as ``ptr(t)``; the caller keeps
    them alive, and PyTorch's allocator orders their reuse on the stream."""
    import torch

    fn = function(kernel, symbol, [*argtypes, ctypes.c_void_p])
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        code = fn(*args, stream)
    if code != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed with error code {code}")


def traced(label: str, lanes: int):
    """Decorator of a kernel wrapper: while a profiler runs
    (``runtime.log.tracing()``), a call whose argument ``lanes`` (by
    position) holds elements is the span ``label`` of ``runtime.log``'s
    recorder, a range ``bgt::<label>`` in a ``maybe_profile`` trace; a call
    without elements launches nothing and gets no span.  A state dict as
    ``lanes`` counts by its ``begin``.  Otherwise a call
    costs that one check."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            x = args[lanes]
            if not _log.tracing() or (x["begin"] if isinstance(x, dict) else x).numel() == 0:
                return fn(*args, **kwargs)
            with _log.span(label):
                return fn(*args, **kwargs)

        return call

    return wrap


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
