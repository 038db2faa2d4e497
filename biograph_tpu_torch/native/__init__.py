"""The native FASTQ scanner, built with g++ at first use and loaded with ctypes.

Counterpart of ``biograph_tpu/native/__init__.py`` (FASTQ half: the reference
parses reads in C++, modules/build_seqset/read_importer.cpp, so the per-byte
work here is C++ too).  ``native/fastq_scan.cpp`` has a plain C interface;
it is compiled into ``biograph_tpu_torch/_kernels_build/`` (the directory
``ops/_build.py`` builds the CUDA kernels into, never committed), under a
name keyed by the source's hash and the flags, and nothing is written next
to the source.  The flags name no machine (no ``-march=native``), so a
library built on one host runs on another.

A missing compiler or a failed build raises: ``io/fastq.read_fastq`` does
not fall back to the numpy parser behind the caller's back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from biograph_tpu_torch.ops._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastq_scan.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB = None


def _lib_path() -> str:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libfastq_scan-{digest.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, SOURCE, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native FASTQ scanner cannot be built") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed for the FASTQ scanner (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The scanner's library, built first if need be."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = _lib_path()
        if not os.path.isfile(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.fastq_scan.restype = ctypes.c_longlong
        lib.fastq_scan.argtypes = [
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.c_int,
        ]
        lib.fastq_dims.restype = ctypes.c_int
        lib.fastq_dims.argtypes = [
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.pack_codes_2bit.restype = None
        lib.pack_codes_2bit.argtypes = [
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_longlong,
        ]
        _LIB = lib
        return lib


def _alloc(shape, dtype, spill_dir, name):
    """Output buffer: RAM by default, disk-backed memmap under spill_dir —
    WGS-scale imports hold reads on disk, not in host memory (the
    reference's analog is part_repo's file-backed partitions)."""
    if spill_dir is None:
        return np.zeros(shape, dtype)
    os.makedirs(spill_dir, exist_ok=True)
    return np.memmap(os.path.join(spill_dir, name + ".mm"), dtype, "w+", shape=shape)


def fastq_scan_native(buf, with_quals: bool = True, spill_dir: str | None = None):
    """Parse FASTQ bytes (``bytes`` or a uint8 array, e.g. a memmap) with the
    native scanner.

    Returns (codes [R, L], quals [R, L] | None, lengths [R]); spill_dir puts
    the matrices on disk.  Raises ValueError on malformed input and
    RuntimeError when the library cannot be built."""
    lib = get_lib()
    arr = np.frombuffer(buf, np.uint8) if isinstance(buf, bytes) else np.ascontiguousarray(buf)
    n_reads = ctypes.c_longlong(0)
    max_len = ctypes.c_longlong(0)
    rc = lib.fastq_dims(arr.ctypes.data, len(arr), ctypes.byref(n_reads), ctypes.byref(max_len))
    if rc != 0:
        raise ValueError("malformed FASTQ (native scanner)")
    R, L = n_reads.value, max(max_len.value, 1)
    codes = _alloc((R, L), np.uint8, spill_dir, "fq_codes")
    quals = _alloc((R, L), np.uint8, spill_dir, "fq_quals") if with_quals else np.zeros((1, 1), np.uint8)
    lengths = np.zeros(R, np.int32)
    got = lib.fastq_scan(
        arr.ctypes.data,
        len(arr),
        codes.ctypes.data,
        quals.ctypes.data,
        lengths.ctypes.data,
        R,
        L,
        1 if with_quals else 0,
    )
    if got != R:
        raise ValueError(f"native FASTQ scan parsed {got}/{R} reads")
    return codes, (quals if with_quals else None), lengths

