"""Device-memory budgeting for the stages that grow with the input (torch).

Counterpart of ``biograph_tpu/runtime/resources.py``.  The suffix sort of
``build/seqset_build.py`` consults the budget and switches to the
prefix-partitioned multi-pass build when the port's own plan says the
in-memory sort would not fit.

``BUDGET_BYTES`` stands in for the JAX package's ``BGT_HBM_BUDGET_BYTES``:
a byte count set here is the budget ``detect`` returns, whatever the device.
Nothing reads the environment.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from biograph_tpu_torch import resolve_device

BUDGET_BYTES = None
CPU_BYTES = 8 << 30  # the JAX package's figure where the device reports none


@dataclass(frozen=True)
class MemoryBudget:
    """Device-memory budget in bytes for a single resident working set."""

    bytes: int

    @staticmethod
    def detect(device="cuda", fraction: float = 0.5) -> "MemoryBudget":
        """``fraction`` of the device's total memory (``mem_get_info``); on
        the CPU, of CPU_BYTES.  The fraction leaves room for the allocator's
        cache and the stages' other tensors."""
        if BUDGET_BYTES is not None:
            return MemoryBudget(bytes=int(BUDGET_BYTES))
        dev = resolve_device(device)
        if dev.type == "cuda":
            total = torch.cuda.mem_get_info(dev)[1]
        else:
            total = CPU_BYTES
        return MemoryBudget(bytes=int(total * fraction))

    def fits(self, nbytes: int) -> bool:
        return nbytes <= self.bytes

    def passes_needed(self, nbytes: int) -> int:
        return max(1, -(-nbytes // self.bytes))
