"""What the per-command trace (``--profile DIR``, ``runtime/log.maybe_profile``)
costs on one GPU.

    python3 scripts/torch_trace_cost.py [OUT.json]

(1) The profiler's start in a fresh process: one process a run, CUDA
initialised first, then two traces of one small operation each, the first
and the second start timed on the host clock (start to the file written).
(2) A ``push_front`` wrapper call's host time at 4096 ranges outside a trace
and inside one (the ``bgt::push_front`` range on), each the mean of 2000
calls, over the store of (3).  (3) The discovery command ``chip_smoke.py``
traces (leg 4's library, made here from seed 12406 and built by ``create
--paired --correct``; the wavefront alone over the smallest planted SV and
10 000 bases each side), each run in a fresh process, untraced and traced in
turns (untraced, traced, traced, untraced): ``cli.main``'s seconds, the
trace's export seconds, bytes and events.  The card's name and power limit
come first; one JSON line follows (also written to OUT.json when given).
"""

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# a fresh process: CUDA up, then two traces of one small operation
STARTS = r"""
import json, sys, time, torch
from biograph_tpu_torch.runtime.log import maybe_profile
x = torch.ones(1024, device="cuda") + 1
torch.cuda.synchronize()
out = []
for tag in ("first", "second"):
    t0 = time.perf_counter()
    with maybe_profile(tag, sys.argv[1]):
        x = x + 1
    out.append(time.perf_counter() - t0)
print(json.dumps({"first_s": out[0], "second_s": out[1]}))
"""

# a fresh process: cli.main(argv) timed, and the trace's export when traced
COMMAND = r"""
import json, sys, time, torch
from torch.profiler import profile
from biograph_tpu_torch import cli
export = []
real = profile.export_chrome_trace
def timed_export(self, path):
    t0 = time.perf_counter()
    real(self, path)
    export.append(time.perf_counter() - t0)
profile.export_chrome_trace = timed_export
t0 = time.perf_counter()
cli.main(sys.argv[1:])
print(json.dumps({"seconds": time.perf_counter() - t0, "export_s": export[0] if export else None}))
"""


def fresh(code, *args):
    """The JSON line a fresh process running ``code`` prints last."""
    out = subprocess.run([sys.executable, "-c", code, *args], check=True, capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main():
    import torch

    import chip_smoke as cs
    from biograph_tpu_torch import cli
    from biograph_tpu_torch.api import BioGraph
    from biograph_tpu_torch.ops import rank4 as rank4_ops
    from biograph_tpu_torch.runtime.log import maybe_profile

    if not torch.cuda.is_available():
        sys.exit("torch_trace_cost: CUDA is not available; this script runs only on a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"card": card}
    tmp = tempfile.TemporaryDirectory()

    out["starts"] = [fresh(STARTS, os.path.join(tmp.name, f"starts{i}")) for i in range(2)]

    genome = cs.leg_genome()
    codes, lengths, truth = cs.sv_paired_library(genome, **cs.SV_LIBRARY)
    fq, fa = cs.write_leg_inputs(tmp.name, genome, codes, lengths)
    bgt = os.path.join(tmp.name, "sample.bgt")
    cli.main(["create", "--reads", fq, "--out", bgt, *cs.PIPELINE_FLAGS, "--device", "cuda"])

    dev = torch.device("cuda")
    d = BioGraph(bgt, device=dev).seqset.d
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    n, R = d.n_entries, 4096
    begin = torch.randint(0, n, (R,), device=dev, generator=g)
    end = (begin + torch.randint(0, 50, (R,), device=dev, generator=g)).clamp(max=n)
    size = torch.randint(0, 100, (R,), device=dev, dtype=torch.int32, generator=g)
    b = torch.randint(0, 4, (R,), device=dev, generator=g)
    args = (d.rank_blocks, d.entry_sizes, d.fixed, begin, end, size, b)

    def host_us(calls=2000):
        for _ in range(20):
            rank4_ops.push_front(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            rank4_ops.push_front(*args)
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
        return seconds / calls * 1e6

    host = {"ranges": R, "outside_us": host_us()}
    with maybe_profile("host", os.path.join(tmp.name, "host")):
        host["inside_us"] = host_us()
    host["outside_again_us"] = host_us()
    out["push_front_call"] = host

    argv, region, sv = cs.trace_argv(dev, bgt, fa, truth["sv"])
    out["command"] = {"region": list(region), "sv": list(sv), "runs": []}
    for i, traced in enumerate((False, True, True, False)):
        extra = ["--out", os.path.join(tmp.name, f"run{i}.vcf")]
        trace_dir = os.path.join(tmp.name, f"trace{i}")
        extra += ["--profile", trace_dir] if traced else []
        run = {"traced": traced, **fresh(COMMAND, *argv, *extra)}
        if traced:
            path = os.path.join(trace_dir, "discovery.json")
            run["bytes"] = os.path.getsize(path)
            run["events"] = len(json.load(open(path))["traceEvents"])
        out["command"]["runs"].append(run)
    tmp.cleanup()
    print(json.dumps(out), flush=True)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
