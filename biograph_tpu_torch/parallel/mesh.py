"""The mesh of shards over processes, and the sharded pileup step (torch).

Counterpart of ``biograph_tpu/parallel/mesh.py``.  Where the JAX package lays
devices out as a ``jax.sharding.Mesh`` and combines partial results with
XLA collectives, here a ``Mesh`` lays out ``world_size x shards_per_rank``
shards, a process's shards a contiguous run of them in row-major order over
the named axes, and partial results meet in ``torch.distributed`` collectives
over the processes that an axis spans.

Axes:
  * ``data``  - read batches shard along this axis;
  * ``model`` - the seqset's entry ranges (``sharded_seqset``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch
import torch.distributed as dist

from biograph_tpu_torch import resolve_device


@dataclass(frozen=True)
class Mesh:
    """Named axes over ``world_size * shards_per_rank`` shards.  Shard g
    belongs to process g // shards_per_rank."""

    axis_names: tuple
    axis_sizes: tuple
    world_size: int
    rank: int
    shards_per_rank: int
    device: torch.device
    process_sizes: tuple  # processes along each axis

    @staticmethod
    def build(axis_shapes: dict, world_size: int, rank: int, shards_per_rank: int = 1, device="cuda") -> "Mesh":
        names = tuple(axis_shapes)
        sizes = list(axis_shapes.values())
        n = world_size * shards_per_rank
        if sum(s == -1 for s in sizes) > 1:
            raise ValueError(f"mesh {axis_shapes}: at most one axis may be -1")
        fixed = int(np.prod([s for s in sizes if s != -1]))
        sizes = [n // fixed if s == -1 else s for s in sizes]
        if int(np.prod(sizes)) != n:
            raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} shards")
        # a process's shards fill the trailing axes first
        left = shards_per_rank
        procs = []
        for s in reversed(sizes):
            if left % s == 0:
                procs.append(1)
                left //= s
            elif s % left == 0:
                procs.append(s // left)
                left = 1
            else:
                raise ValueError(f"{shards_per_rank} shards a process do not tile mesh {dict(zip(names, sizes))}")
        return Mesh(names, tuple(sizes), world_size, rank, shards_per_rank, resolve_device(device), tuple(reversed(procs)))

    @cached_property
    def device_mesh(self):
        """The ``torch.distributed`` DeviceMesh of the processes (its axes
        the mesh's, each the processes it spans), None at one process.
        Made by the first ``group`` call, which every process makes."""
        if self.world_size == 1:
            return None
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(self.device.type, self.process_sizes, mesh_dim_names=self.axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    def local_coords(self, axis: str) -> list:
        """This process's distinct coordinates along ``axis``, ascending: the
        shards of that axis it holds."""
        first = self.rank * self.shards_per_rank
        ids = np.arange(first, first + self.shards_per_rank)
        coords = np.unravel_index(ids, self.axis_sizes)[self.axis_names.index(axis)]
        return sorted({int(c) for c in coords})

    def group(self, axis: str):
        """The process group that sums over ``axis``: None without a
        process group (one process holds every shard), the whole world at
        one process, else the DeviceMesh's group of the axis."""
        if not dist.is_initialized():
            return None
        if self.device_mesh is None:
            return dist.group.WORLD
        return self.device_mesh.get_group(axis)


def make_mesh(shards_per_rank: int = 1, axis: str = "data", device="cuda") -> Mesh:
    """A one-axis mesh over every process's shards."""
    from biograph_tpu_torch.parallel.distributed import global_mesh

    return global_mesh({axis: -1}, shards_per_rank, device)


def sharded_pileup_step(mesh: Mesh, ref_kmers, ref_positions, ref_codes, k: int):
    """The sharded pileup step: reads (data-sharded) -> pileup counts
    (summed over the data axis, replicated).

    step(kmer_tab, pos_tab, ref, codes, lengths) takes the whole read batch
    on every process; each process seeds (binary search of each read's first
    k-mer), verifies (mismatch count) and scatter-adds (``index_add_``) the
    reads of its data slices into int32 [4, ref_len], then one all_reduce
    over the data axis's processes sums them.  The index is replicated;
    k-mers are int64 (k <= 31)."""
    if not 0 < k <= 31:
        raise ValueError(f"k-mers are int64 here: k must be in 1..31, not {k}")
    ref_len = ref_codes.shape[0]
    data_slices = mesh.local_coords("data")
    n_slices = mesh.shape["data"]

    def counts_of(kmer_tab, pos_tab, ref, codes, lengths):
        B, L = codes.shape
        dev = codes.device
        q = _first_kmers(codes, k)
        loc = torch.searchsorted(kmer_tab, q).clamp(0, kmer_tab.shape[0] - 1)
        hit = kmer_tab[loc] == q
        start = torch.where(hit, pos_tab[loc], -1)
        okpos = (start >= 0) & (start + lengths <= ref_len)
        s = start.clamp(0, max(ref_len - L, 0))
        tgt = (s[:, None] + torch.arange(L, dtype=torch.int64, device=dev)[None, :]).clamp(0, ref_len - 1)
        vb = torch.arange(L, device=dev)[None, :] < lengths[:, None]
        mm = ((ref[tgt] != codes) & vb).sum(dim=1)
        placed = okpos & (mm <= 3)
        flat = codes.to(torch.int64) * ref_len + tgt
        w = (placed[:, None] & vb).to(torch.int32)
        counts = torch.zeros(4 * ref_len, dtype=torch.int32, device=dev)
        return counts.index_add_(0, flat.reshape(-1), w.reshape(-1)).view(4, ref_len)

    group = mesh.group("data")

    def step(kmer_tab, pos_tab, ref, codes, lengths):
        codes_sl = torch.tensor_split(codes, n_slices)
        lens_sl = torch.tensor_split(lengths.to(torch.int64), n_slices)
        counts = sum(counts_of(kmer_tab, pos_tab, ref, codes_sl[d], lens_sl[d]) for d in data_slices)
        if group is not None:
            dist.all_reduce(counts, group=group)
        return counts

    return step


def _first_kmers(codes, k: int):
    """Each read's first k-mer, 2 bits a base, int64 [B]."""
    acc = torch.zeros(codes.shape[0], dtype=torch.int64, device=codes.device)
    for i in range(k):
        acc = (acc << 2) | codes[:, i].to(torch.int64)
    return acc
