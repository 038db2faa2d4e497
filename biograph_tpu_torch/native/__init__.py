"""The native read scanners, built with g++ at first use and loaded with ctypes.

Counterpart of ``biograph_tpu/native/__init__.py`` (the reference parses
reads in C++, modules/build_seqset/read_importer.cpp, so the per-byte work
here is C++ too): the FASTQ scanner, the BAM record scanner and the BGZF
block scan.  The BGZF blocks inflate in Python's ``zlib`` over a thread
pool (it releases the GIL while it inflates), so the library links no
zlib.  ``native/fastq_scan.cpp`` has a plain C interface;
it is compiled into ``biograph_tpu_torch/_kernels_build/`` (the directory
``ops/_build.py`` builds the CUDA kernels into, never committed), under a
name keyed by the source's hash and the flags, and nothing is written next
to the source.  The flags name no machine (no ``-march=native``), so a
library built on one host runs on another.

A missing compiler or a failed build raises: ``io/fastq.read_fastq`` does
not fall back to the numpy parser behind the caller's back, nor
``io/bam.read_bam`` to a Python record loop.  A corrupt or truncated BGZF
block raises too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

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
        raise RuntimeError("g++ not found: the native FASTQ scanner (FASTQ, BAM and BGZF scans) cannot be built") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed for the FASTQ scanner (FASTQ, BAM and BGZF scans; exit {proc.returncode}):\n"
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
        lib.bam_dims.restype = ctypes.c_int
        lib.bam_dims.argtypes = [
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.bam_scan.restype = ctypes.c_longlong
        lib.bam_scan.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong,
            ctypes.c_longlong,
        ]
        lib.bgzf_scan.restype = ctypes.c_longlong
        lib.bgzf_scan.argtypes = [
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_void_p,
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


def bgzf_blocks(arr: np.ndarray):
    """The BGZF block table of a compressed buffer: (c_off int64, c_size
    int32, u_size int32) a block, or None when a member lacks the BGZF
    'BC' subfield (plain gzip, read by the serial walk) or the buffer holds
    no block."""
    n = len(arr)
    if n < 18:
        return None
    max_blocks = n // 28 + 2  # the EOF marker block is 28 bytes, the minimum
    c_off = np.zeros(max_blocks, np.int64)
    c_size = np.zeros(max_blocks, np.int32)
    u_size = np.zeros(max_blocks, np.int32)
    k = get_lib().bgzf_scan(arr.ctypes.data, n, c_off.ctypes.data, c_size.ctypes.data, u_size.ctypes.data, max_blocks)
    if k <= 0:
        return None
    if k == max_blocks and int(c_off[k - 1]) + int(c_size[k - 1]) < n:
        raise ValueError("BGZF: more blocks than the scan table holds")
    return c_off[:k], c_size[:k], u_size[:k]


def bgzf_decompress_native(buf, n_threads: int | None = None, spill_dir: str | None = None):
    """Parallel BGZF decompression (the htslib multi-threaded-reader analog).

    ``buf`` is any uint8 buffer (bytes or np.memmap).  The native scan finds
    the blocks; each block's raw deflate payload inflates with
    ``zlib.decompress(payload, -15)`` on a pool of threads, straight into
    its place in the output.  Returns a uint8 array of the concatenated
    stream (a memmap under spill_dir), or None when a member is not BGZF
    (the caller takes the serial walk, which reads plain gzip too).  Raises
    ValueError on a corrupt block or one whose ISIZE differs from the bytes
    it inflates to."""
    arr = np.frombuffer(buf, np.uint8) if isinstance(buf, bytes) else buf
    table = bgzf_blocks(arr)
    if table is None:
        return None
    c_off, c_size, u_size = table
    k = len(c_off)
    u_off = np.zeros(k + 1, np.int64)
    np.cumsum(u_size, out=u_off[1:])
    out = _alloc((int(u_off[k]),), np.uint8, spill_dir, "bgzf_out")
    xlen = arr[c_off + 10].astype(np.int64) | (arr[c_off + 11].astype(np.int64) << 8)
    lo = c_off + 12 + xlen
    hi = c_off + c_size - 8  # less the CRC32 and ISIZE trailer
    mv = memoryview(arr)

    def inflate(i):
        try:
            data = zlib.decompress(mv[lo[i] : hi[i]], -15)
        except zlib.error as e:
            raise ValueError(f"BGZF block {i} at byte {int(c_off[i])} is corrupt: {e}") from e
        if len(data) != u_size[i]:
            raise ValueError(
                f"BGZF block {i} at byte {int(c_off[i])} inflates to {len(data)} bytes, its ISIZE says {int(u_size[i])}"
            )
        out[u_off[i] : u_off[i + 1]] = np.frombuffer(data, np.uint8)

    nt = n_threads or min(os.cpu_count() or 1, 16)
    with ThreadPoolExecutor(max_workers=nt) as pool:
        for _ in pool.map(inflate, range(k)):
            pass
    return out


def bam_scan_native(aln_buf, keep_unmapped: bool = True, spill_dir: str | None = None):
    """Parse decompressed BAM alignment records natively.

    Returns (codes, quals, lengths, flags, names); spill_dir puts the
    code/qual matrices on disk.  Raises RuntimeError when the library
    cannot be built."""
    lib = get_lib()
    arr = np.frombuffer(aln_buf, np.uint8) if isinstance(aln_buf, bytes) else np.ascontiguousarray(aln_buf)
    nr = ctypes.c_longlong(0)
    ml = ctypes.c_longlong(0)
    nb = ctypes.c_longlong(0)
    lib.bam_dims(arr.ctypes.data, len(arr), int(keep_unmapped), ctypes.byref(nr), ctypes.byref(ml), ctypes.byref(nb))
    R, L = nr.value, max(ml.value, 1)
    codes = _alloc((R, L), np.uint8, spill_dir, "bam_codes")
    quals = _alloc((R, L), np.uint8, spill_dir, "bam_quals")
    lengths = np.zeros(R, np.int32)
    flags = np.zeros(R, np.int32)
    name_off = np.zeros(R + 1, np.int64)
    name_buf = np.zeros(max(nb.value, 1), np.uint8)
    got = lib.bam_scan(
        arr.ctypes.data, len(arr), int(keep_unmapped),
        codes.ctypes.data, quals.ctypes.data, lengths.ctypes.data,
        flags.ctypes.data, name_off.ctypes.data, name_buf.ctypes.data,
        R, L,
    )
    if got != R:
        raise ValueError(f"native BAM scan parsed {got}/{R} records")
    raw = name_buf.tobytes()
    names = [raw[name_off[i] : name_off[i + 1]] for i in range(R)]
    return codes, quals, lengths, flags, names


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

