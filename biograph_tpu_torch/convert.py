"""Carry a seqset or readmap between the two packages as numpy arrays.

The JAX package's ``Seqset`` / ``Readmap`` fields, taken as numpy arrays by
the caller, become the port's tensors on a chosen device, and back.  The
port never sees a jax array: whoever calls does the ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from biograph_tpu_torch import resolve_device

SEQSET_DTYPES = {
    "fixed": np.int64,
    "prev_words": np.uint32,
    "prev_cum": np.int64,
    "entry_sizes": np.int32,
    "shared": np.int32,
    "pop_sel": np.int64,
}
READMAP_DTYPES = {
    "offsets": np.int64,
    "read_lengths": np.int32,
    "is_forward": np.bool_,
    "mate_pair_ptr": np.int64,
    "read_ids": np.int64,
}


def _tensor(arr, dtype, dev):
    arr = np.ascontiguousarray(np.asarray(arr), dtype=dtype)
    if dtype is np.uint32:
        arr = arr.view(np.int32)  # same bits; torch has no uint32 arithmetic
    return torch.from_numpy(arr.copy()).to(dev)


def seqset_from_numpy(arrays: dict, device="cuda"):
    """A port ``Seqset`` from numpy arrays keyed by field name (``fixed``,
    ``prev_words`` uint32, ``prev_cum``, ``entry_sizes``, ``shared``,
    ``pop_sel``) plus the scalars ``n_entries`` and ``max_entry_len``."""
    from biograph_tpu_torch.index.seqset import Seqset

    dev = resolve_device(device)
    return Seqset(
        n_entries=int(arrays["n_entries"]),
        max_entry_len=int(arrays["max_entry_len"]),
        **{k: _tensor(arrays[k], dt, dev) for k, dt in SEQSET_DTYPES.items()},
    )


def seqset_to_numpy(seqset) -> dict:
    """The reverse of ``seqset_from_numpy`` (``prev_words`` as uint32)."""
    out = {
        "n_entries": int(seqset.n_entries),
        "max_entry_len": int(seqset.max_entry_len),
    }
    for k, dt in SEQSET_DTYPES.items():
        arr = getattr(seqset, k).cpu().numpy()
        out[k] = arr.view(np.uint32) if dt is np.uint32 else arr.astype(dt, copy=False)
    return out


def readmap_from_numpy(arrays: dict, seqset, device="cuda"):
    """A port ``Readmap`` over ``seqset`` from numpy arrays keyed by field
    name (``offsets``, ``read_lengths``, ``is_forward``, ``mate_pair_ptr``,
    ``read_ids``)."""
    from biograph_tpu_torch.index.readmap import Readmap

    dev = resolve_device(device)
    return Readmap(
        seqset=seqset,
        **{k: _tensor(arrays[k], dt, dev) for k, dt in READMAP_DTYPES.items()},
    )


def reference_from_numpy(flat, is_n, contigs):
    """A port ``Reference`` from the flat code array, the N mask and the
    contigs as (name, start, length) triples: host numpy, as in the JAX
    package, so one reference can be handed to both."""
    from biograph_tpu_torch.index.reference import Contig, Reference

    return Reference(
        flat=np.ascontiguousarray(flat, dtype=np.uint8),
        is_n=np.ascontiguousarray(is_n, dtype=bool),
        contigs=[Contig(name=str(n), start=int(s), length=int(l)) for n, s, l in contigs],
    )
