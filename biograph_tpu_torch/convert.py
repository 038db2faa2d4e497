"""Carry a seqset, a readmap, a reference, a classifier or k-mer counts
and sets between the two packages as numpy arrays.

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


def classifier_from_arrays(arrays: dict, device="cuda"):
    """A port ``Classifier`` (one output) or ``GtClassifier`` (one output a
    genotype class) from a JAX model's parameters as numpy arrays:
    ``w0..w2`` as ``[in, out]``, ``b0..b2``, ``mean`` and ``std``.  With
    those weights both packages compute the same function."""
    from biograph_tpu_torch.classifier.model import Classifier, GtClassifier

    params = {k: np.asarray(v, np.float32) for k, v in arrays.items() if k[0] in "wb"}
    last = max(int(k[1:]) for k in params if k[0] == "w")
    cls = Classifier if params[f"w{last}"].shape[1] == 1 else GtClassifier
    return cls(params, arrays["mean"], arrays["std"], device)


def kmer_counts_from_numpy(arrays: dict):
    """A port ``KmerCounts`` from ``k`` and the arrays ``kmers`` (uint64 in
    the JAX package, every value below 2^62), ``fwd`` and ``rev``: a JAX
    ``KmerCounts`` passes as ``vars(counts)``."""
    from biograph_tpu_torch.kmers.count import KmerCounts

    return KmerCounts(
        k=int(arrays["k"]),
        kmers=np.asarray(arrays["kmers"]).astype(np.int64),
        fwd=np.asarray(arrays["fwd"], np.int64),
        rev=np.asarray(arrays["rev"], np.int64),
    )


def kmer_set_from_numpy(arrays: dict, device="cuda"):
    """A port ``KmerSet`` on ``device`` from ``k`` and the sorted canonical
    ``kmers``, as a JAX ``KmerSet.save_arrays()`` gives them."""
    from biograph_tpu_torch.kmers.kmer_set import KmerSet

    kmers = np.ascontiguousarray(np.asarray(arrays["kmers"]).astype(np.int64))
    return KmerSet(k=int(arrays["k"]), kmers=torch.from_numpy(kmers).to(resolve_device(device)))
