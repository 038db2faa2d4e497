"""Packed integer vectors and 1:many index maps (torch).

Counterpart of ``biograph_tpu/core/packed.py``: plain typed tensors plus CSR
offset arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """int64 [len(x) + 1]: out[i] = sum(x[:i])."""
    out = torch.zeros(x.shape[0] + 1, dtype=torch.int64, device=x.device)
    torch.cumsum(x.to(torch.int64), 0, out=out[1:])
    return out


@dataclass
class SparseMulti:
    """1:many mapping from a sparse domain [0, n) to dense ids [0, total).

    CSR layout: ``offsets`` int64[n+1]; entry i owns dense range
    [offsets[i], offsets[i+1]).  ``values`` stores the dense payload order.
    """

    offsets: torch.Tensor  # int64 [n+1]
    values: torch.Tensor  # int64 [total] — dense ids in entry order

    @staticmethod
    def from_pairs(keys, values, n: int) -> "SparseMulti":
        """Build from (key, value) pairs; keys in [0, n)."""
        keys = torch.as_tensor(keys).to(torch.int64)
        values = torch.as_tensor(values, device=keys.device).to(torch.int64)
        order = torch.sort(keys, stable=True).indices
        counts = torch.bincount(keys, minlength=n)
        return SparseMulti(
            offsets=exclusive_cumsum(counts), values=values[order]
        )

    @property
    def n(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def total(self) -> int:
        return int(self.offsets[-1])

    def lookup_range(self, i):
        """Batched: dense [start, end) range for sparse index i."""
        i = torch.as_tensor(i, device=self.offsets.device).to(torch.int64)
        return self.offsets[i], self.offsets[i + 1]

    def reverse_lookup(self, dense_ids):
        """Batched: sparse index owning each dense id (searchsorted)."""
        ids = torch.as_tensor(dense_ids, device=self.offsets.device).to(
            torch.int64
        )
        return torch.searchsorted(self.offsets, ids, right=True) - 1
