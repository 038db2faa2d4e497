"""The entry-sharded seqset serving discovery (torch).

Counterpart of ``biograph_tpu/parallel/sharded_discovery.py``.  A seqset
whose per-entry tables (the rank structure, ``shared``, the entry sizes,
``pop_sel`` and the two trunc tables: about 40 B an entry) outgrow one card
is cut by entry range over the processes of a run, and
``discover_variants(..., engine=ShardedDiscoveryEngine(ss, mesh))`` runs the
port's own stage functions over it: the dense front end's restart chains,
find-window filter and bisection (their step-by-step forms), the anchor
scan, the beam wavefront with its trunc tables.  The stages are plain
functions of a query engine, so the engine's entry point is its shard-local
device (``engine.d``, a ``_ShardLocalDevice``) passed where the local route
passes ``Seqset.d``; every seqset query is its local shards' contribution
and one all_reduce.  The records are the local engine's.

Memory a process: its shards of the rank-block tables and of ``shared``,
the sizes and both trunc tables (discovery reads no ``pop_sel``); only the
lane state, the doubled reference and the span table are replicated.  The readmap that
scores the assemblies is not sharded.
"""

from __future__ import annotations

import numpy as np
import torch

from biograph_tpu_torch.parallel.mesh import Mesh
from biograph_tpu_torch.parallel.sharded_seqset import ShardedRankArrays, _ShardLocalDevice

__all__ = ["ShardedDiscoveryEngine", "_ShardLocalDevice"]


class ShardedDiscoveryEngine:
    """The seqset sharded by entry range over ``mesh[axis]``, this process's
    shards on ``mesh.device``: the device of ``discover_variants(...,
    engine=)``.  Every process of the run builds one over the same seqset
    and makes the same calls."""

    def __init__(self, ss, mesh: Mesh, axis: str = "model"):
        self.mesh = mesh
        self.axis = axis
        self.S = mesh.shape[axis]
        self.shards = mesh.local_coords(axis)
        arrays = ShardedRankArrays.build(ss, self.S, shards=self.shards, device=mesh.device)
        self.Re = arrays.shared.shape[1]
        self.d = _ShardLocalDevice(arrays, mesh.group(axis))
        self._shared_host = ss.shared.cpu()
        self._trunc: dict = {}

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def replicate(self, a) -> torch.Tensor:
        """A host array as a tensor on this process's device (every process
        holds the same)."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def trunc_tables(self, c: int):
        """This process's shards of the widen tables for threshold c (the
        semantics of ``variants/discover._trunc_tables``): prev_lt and
        next_lt as int64 [local shards, Re], built on the host from
        ``shared`` and padded with -1 and n past the last entry."""
        hit = self._trunc.get(c)
        if hit is None:
            shared = self._shared_host
            n = shared.shape[0]
            idx = torch.arange(n, dtype=torch.int64)
            lt = shared < c
            prev_lt = torch.cummax(torch.where(lt, idx, -1), 0).values
            next_lt = torch.cummin(torch.where(lt, idx, n).flip(0), 0).values.flip(0)
            sel = torch.as_tensor(self.shards)

            def local(a, pad):
                out = torch.full((self.Re * self.S,), pad, dtype=torch.int64)
                out[:n] = a
                return out.view(self.S, self.Re)[sel].to(self.device)

            hit = self._trunc[c] = (local(prev_lt, -1), local(next_lt, n))
        return hit

    def nbytes(self) -> int:
        """Device bytes of this process's shards, the trunc tables built so
        far included."""
        return self.d.nbytes() + sum(t.numel() * t.element_size() for pair in self._trunc.values() for t in pair)
