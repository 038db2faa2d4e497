"""Pluggable storage for the file data plane (path abstraction).

Counterpart of ``biograph_tpu/runtime/storage.py`` (the reference routes
every artifact path through its ``path`` wrapper, modules/io/path.h, and
manifests name artifacts by URL, mapred/manifest.h:79): the run manifest
and the stage artifacts resolve through this registry, so a deployment
mounts an object store by registering a scheme instead of patching call
sites.

Built-ins: plain paths and ``file://`` (local disk), and ``s3://``, backed
by boto3 when it is installed; without it, constructing the backend raises
a clear error instead of failing deep inside a write.  Register a scheme
with ``register_scheme("gs", factory)``.
"""

from __future__ import annotations

import io
import json
import os
from typing import Callable, Dict, Tuple


class Storage:
    """The IO surface the pipeline needs from a storage backend."""

    def open(self, path: str, mode: str = "r"):
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def publish(self, tmp: str, dst: str) -> None:
        """Atomically make ``tmp`` visible as ``dst`` (readers never see a
        partial artifact)."""
        raise NotImplementedError

    def listdir(self, path: str):
        raise NotImplementedError


class LocalStorage(Storage):
    def _strip(self, path: str) -> str:
        return path[7:] if path.startswith("file://") else path

    def open(self, path: str, mode: str = "r"):
        return open(self._strip(path), mode)

    def exists(self, path: str) -> bool:
        return os.path.exists(self._strip(path))

    def makedirs(self, path: str) -> None:
        os.makedirs(self._strip(path), exist_ok=True)

    def publish(self, tmp: str, dst: str) -> None:
        os.replace(self._strip(tmp), self._strip(dst))

    def listdir(self, path: str):
        return os.listdir(self._strip(path))


class S3Storage(Storage):
    """Object-store backend (boto3); publish is copy-then-delete, atomic per
    object.  Raises at construction when boto3 is not installed."""

    def __init__(self):
        try:
            import boto3
        except ImportError as e:
            raise RuntimeError(
                "s3:// paths need boto3, which is not installed in this "
                "environment; register a custom scheme or use local paths"
            ) from e
        self._s3 = boto3.client("s3")

    @staticmethod
    def _split(path: str) -> Tuple[str, str]:
        bucket, _, key = path[5:].partition("/")
        return bucket, key

    def open(self, path: str, mode: str = "r"):
        bucket, key = self._split(path)
        if "r" in mode:
            body = self._s3.get_object(Bucket=bucket, Key=key)["Body"].read()
            return io.BytesIO(body) if "b" in mode else io.StringIO(body.decode())
        out = io.BytesIO() if "b" in mode else io.StringIO()
        s3 = self._s3

        class _Writer:
            def __enter__(self):
                return out

            def __exit__(self, *exc):
                if not any(exc):
                    data = out.getvalue()
                    s3.put_object(Bucket=bucket, Key=key, Body=data.encode() if isinstance(data, str) else data)

        return _Writer()

    def exists(self, path: str) -> bool:
        bucket, key = self._split(path)
        try:
            self._s3.head_object(Bucket=bucket, Key=key)
            return True
        except Exception:
            return False

    def makedirs(self, path: str) -> None:
        pass  # object stores have no directories

    def publish(self, tmp: str, dst: str) -> None:
        sb, sk = self._split(tmp)
        db, dk = self._split(dst)
        self._s3.copy_object(Bucket=db, Key=dk, CopySource={"Bucket": sb, "Key": sk})
        self._s3.delete_object(Bucket=sb, Key=sk)

    def listdir(self, path: str):
        bucket, key = self._split(path)
        resp = self._s3.list_objects_v2(Bucket=bucket, Prefix=key.rstrip("/") + "/")
        return [o["Key"].rsplit("/", 1)[-1] for o in resp.get("Contents", [])]


_SCHEMES: Dict[str, Callable[[], Storage]] = {"": LocalStorage, "file": LocalStorage, "s3": S3Storage}
_CACHE: Dict[str, Storage] = {}


def register_scheme(scheme: str, factory: Callable[[], Storage]) -> None:
    """Plug a storage backend in for ``scheme://`` paths."""
    _SCHEMES[scheme] = factory
    _CACHE.pop(scheme, None)


def scheme_of(path: str) -> str:
    i = path.find("://")
    return path[:i] if i > 0 else ""


def for_path(path: str) -> Storage:
    scheme = scheme_of(path)
    if scheme not in _SCHEMES:
        raise ValueError(f"unknown storage scheme {scheme!r} for {path!r}; register_scheme({scheme!r}, ...) first")
    if scheme not in _CACHE:
        _CACHE[scheme] = _SCHEMES[scheme]()
    return _CACHE[scheme]


def join(base: str, *parts: str) -> str:
    if scheme_of(base):
        return "/".join([base.rstrip("/"), *parts])
    return os.path.join(base, *parts)


def read_json(path: str):
    with for_path(path).open(path) as f:
        return json.load(f)


def write_json_atomic(path: str, obj) -> None:
    st = for_path(path)
    tmp = path + ".tmp"
    with st.open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    st.publish(tmp, path)
