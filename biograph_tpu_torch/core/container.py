"""Versioned, mmap-able artifact container (numpy only, no torch).

Copy of ``biograph_tpu/core/container.py``: the on-disk format is
byte-compatible, so an artifact saved by either package loads in the other.

Counterpart of the reference's ``spiral_file`` (modules/io/spiral_file.h:86-120):
every pipeline stage emits one immutable, UUID-stamped artifact directory that
later stages open read-only (mmap).  Where the reference stores an
uncompressed ZIP of parts with ``part_info.json`` metadata, we store a plain
directory:

    <name>.bgt/
        manifest.json     — uuid, artifact type, version, build stamp, scalars
        <part>.npy        — one numpy array per part (mmap-loaded on open)
        <part>.npy.z      — codec-coded part (zlib/bz2/lzma; reference codec
                            layer analog, modules/io/zip_slice.h etc.;
                            decoded on open, no mmap)

The "immutable, versioned artifact per stage" property is what makes the
pipeline resumable (a stage whose artifact exists is skipped on resume).
"""

from __future__ import annotations

import bz2
import json
import lzma
import os
import uuid
import time
import zlib
from typing import Any, Dict

import numpy as np

MANIFEST = "manifest.json"
FORMAT_VERSION = 1

# codec name -> (compress, decompress); the reference's codec layer offers
# zip/bzip/tunstall/range_coder (modules/io/*_slice.h) — zlib/bz2 map
# directly and lzma covers the entropy-coder class
_CODECS = {
    "zlib": (lambda b: zlib.compress(b, 6), zlib.decompress),
    "bz2": (lambda b: bz2.compress(b, 9), bz2.decompress),
    "lzma": (
        lambda b: lzma.compress(b, preset=3),
        lzma.decompress,
    ),
}


class ArtifactWriter:
    def __init__(self, path: str, kind: str, metadata: Dict[str, Any] | None = None):
        self.path = path
        self.kind = kind
        self.meta: Dict[str, Any] = {
            "format_version": FORMAT_VERSION,
            "kind": kind,
            "uuid": str(uuid.uuid4()),
            "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "scalars": {},
            "parts": {},
        }
        if metadata:
            self.meta["scalars"].update(metadata)
        os.makedirs(path, exist_ok=True)

    def add_array(self, name: str, arr: np.ndarray, codec: str | None = None):
        """Write one part.  A codec stores the array compressed (good for
        cold/archival parts — qualities, names, report tables); hot parts
        stay raw .npy so readers mmap them.  Codecs mirror the reference's
        codec registry (modules/io/zip_slice.h zlib, bzip_slice bzip2, plus
        the range-coder class covered here by lzma): 'zlib' (fast), 'bz2'
        (denser), 'lzma' (densest, slowest)."""
        arr = np.ascontiguousarray(arr)
        part = {"dtype": str(arr.dtype), "shape": list(arr.shape)}
        if codec is not None:
            if codec not in _CODECS:
                raise ValueError(f"unknown codec {codec!r}")
            payload = _CODECS[codec][0](arr.tobytes())
            with open(os.path.join(self.path, name + ".npy.z"), "wb") as f:
                f.write(payload)
            part["codec"] = codec
        else:
            np.save(os.path.join(self.path, name + ".npy"), arr)
        self.meta["parts"][name] = part

    def set_scalar(self, name: str, value: Any):
        self.meta["scalars"][name] = value

    def close(self):
        with open(os.path.join(self.path, MANIFEST), "w") as f:
            json.dump(self.meta, f, indent=1, sort_keys=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()


class ArtifactReader:
    def __init__(self, path: str, expect_kind: str | None = None, mmap: bool = True):
        self.path = path
        with open(os.path.join(path, MANIFEST)) as f:
            self.meta = json.load(f)
        if self.meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"{path}: unsupported artifact format {self.meta.get('format_version')}"
            )
        if expect_kind and self.meta["kind"] != expect_kind:
            raise ValueError(
                f"{path}: artifact kind {self.meta['kind']!r}, expected {expect_kind!r}"
            )
        self._mmap = mmap

    @property
    def uuid(self) -> str:
        return self.meta["uuid"]

    @property
    def kind(self) -> str:
        return self.meta["kind"]

    def scalar(self, name: str, default=None):
        return self.meta["scalars"].get(name, default)

    def array(self, name: str) -> np.ndarray:
        part = self.meta["parts"].get(name, {})
        codec = part.get("codec")
        if codec is not None:
            if codec not in _CODECS:
                raise ValueError(f"{self.path}/{name}: unknown codec {codec!r}")
            with open(os.path.join(self.path, name + ".npy.z"), "rb") as f:
                raw = _CODECS[codec][1](f.read())
            return np.frombuffer(raw, dtype=np.dtype(part["dtype"])).reshape(
                part["shape"]
            )
        return np.load(
            os.path.join(self.path, name + ".npy"),
            mmap_mode="r" if self._mmap else None,
        )

    def names(self):
        return list(self.meta["parts"])


def exists(path: str) -> bool:
    return os.path.isfile(os.path.join(path, MANIFEST))
