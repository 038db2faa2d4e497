"""Cold and warm in-memory seqset build of the port on one GPU, for comparing
two checkouts on the same card.

    python3 scripts/torch_build_cold_warm.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT (a directory holding ``biograph_tpu_torch/`` and
``chip_smoke.py``, e.g. a ``git archive`` of a commit) runs in a fresh
process of its own, in the order given, so pass them in turns (parent,
change, change, parent).  A process builds the kernels, runs
``chip_smoke.edge_checks`` (which warms the allocator and loads every
kernel, as the script does before its main path), then builds the main
path's scaled leg (120 000 reads of 100 bases, seed 12345) three times and
prints one JSON line: each build's seconds (host clock, the device drained
before and after) and its own peak device memory.  The card's name and
power limit come first.
"""

import json
import os
import subprocess
import sys
import time


def measure(checkout):
    sys.path.insert(0, os.path.abspath(checkout))
    import torch

    import chip_smoke as cs
    from biograph_tpu_torch.build.seqset_build import build_seqset
    from biograph_tpu_torch.ops import _build

    _build.build_all()
    dev = torch.device("cuda:0")
    cs.edge_checks(dev)
    genome, codes, lengths = cs.simulate(cs.GENOME, cs.READS, cs.SNPS, cs.READ_LEN)[:3]
    out = {"checkout": checkout}
    for run in ("cold", "warm", "warm2"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        ss = build_seqset(codes, lengths, device=dev)
        torch.cuda.synchronize()
        out[run + "_s"] = time.perf_counter() - t0
        out[run + "_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        del ss
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        measure(sys.argv[2])
        return
    if len(sys.argv) < 2:
        sys.exit("usage: python3 scripts/torch_build_cold_warm.py CHECKOUT [CHECKOUT ...]")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(card, flush=True)
    for checkout in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", checkout], check=True)


if __name__ == "__main__":
    main()
