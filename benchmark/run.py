"""The benchmark of biograph_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in BENCHMARK.json, its configuration, its traffic mix, the
mix's driver (``drivers/<entry>.py``) and, with ``--trace 1``, one reader a
per-layer metric (``layer_metrics/<metric>.py``).  Set-up (imports, the
inputs from the seed, the store, the warm-up calls) is ``setup_s``; then
the window repeats the driver's call, one at a time, for ``--seconds``;
then the program's state is freed and every call's output is compared with
the plain reference.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``); the numbers compared
are also the last lines of standard error.  Exits non-zero, printing no
result, without a CUDA card, with fewer cards than the cell asks for, or
when the JAX package was loaded.

``--sample-seed`` (default 0, the benchmark's sample) draws another sample,
genome and variants, for a look at the check on other layouts; the
benchmark's own runs leave it at 0.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import guard, measure, spec  # noqa: E402

# every build and kernel cache of a run stays in the checkout, at a fixed path
CACHE = os.path.join(ROOT, ".bench_cache")


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20,
        )
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _host_ticks():
    """(all, steal) jiffies of the host's processors, from /proc/stat."""
    try:
        with open("/proc/stat") as f:
            cpu = [int(x) for x in f.readline().split()[1:]]
        return sum(cpu), cpu[7] if len(cpu) > 7 else 0
    except (OSError, ValueError):
        return 0, 0


def _phase(name: str, seconds: float, detail: str = "") -> None:
    print(f"benchmark: {name} {seconds:.3f} s{' (' + detail + ')' if detail else ''}", file=sys.stderr, flush=True)


def end_to_end(cell, calls, setup_s) -> dict:
    """The cell's end-to-end metrics from the window's calls."""
    seconds = [c["seconds"] for c in calls if c["ok"]]
    work = [c["work"] for c in calls if c["ok"]]
    values = {
        "setup_s": setup_s,
        "call_kbp_per_s": lambda: measure.rate(work, seconds),
        "region_call_p95_ms": lambda: measure.percentile(seconds, 95) * 1e3,
    }
    out = {}
    for m in cell.end_to_end:
        v = values[m["name"]]
        out[m["name"]] = {"value": v() if callable(v) else v, "unit": m["unit"]}
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float = T0):
    """One run of ``cell`` on ``device``: (result dict, check lines).  The
    caller has made sure the device is what the cell asks for."""
    import torch

    from benchmark.lib import trace as tr

    on_card = device.type == "cuda"
    driver = cell.driver()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    state = driver.setup(cell, seed, device)
    warm = cell.mix["warm_up_calls"]
    for i in range(warm):  # the window's own call, as set-up
        driver.call(state, i)
    if trace and on_card:
        with tr.profiled(cpu=False):  # the profiler's first start is set-up
            torch.zeros(1, device=device).add_(1)
    if on_card:
        torch.cuda.synchronize()
    # what set-up made lives through the run: the interpreter's collections
    # in the window leave it alone
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0

    _phase("set-up", setup_s)
    calls = []
    prof = None
    ctx_prof = tr.profiled(cpu=False) if trace and on_card else None
    if ctx_prof is not None:
        prof = ctx_prof.__enter__()
    ticks0 = _host_ticks()
    window0 = time.perf_counter()
    try:
        while True:
            c0 = time.perf_counter()
            try:
                got = driver.call(state, warm + len(calls))
                if on_card:
                    torch.cuda.synchronize()
                got.update(ok=True)
            except Exception:  # a failed call counts against the attempted ones
                traceback.print_exc()
                got = {"ok": False, "work": 0, "out": None, "stats": {}}
            got["seconds"] = time.perf_counter() - c0
            calls.append(got)
            window_s = time.perf_counter() - window0
            if window_s >= seconds:
                break
    finally:
        if ctx_prof is not None:
            ctx_prof.__exit__(None, None, None)
    ticks1 = _host_ticks()
    took = sorted(c["seconds"] for c in calls)
    gc.unfreeze()
    _phase("window", window_s, f"{len(calls)} calls, each {took[0]:.4f} s to {took[-1]:.4f} s, median {took[len(took) // 2]:.4f} s")
    print("benchmark: calls' seconds in order: " + " ".join(f"{c['seconds']:.3f}" for c in calls), file=sys.stderr)
    steps = sum(c["stats"].get("wave_steps", 0) for c in calls)
    all_ticks = max(ticks1[0] - ticks0[0], 1)
    print(f"benchmark: window's beam steps {steps}; the host's steal share {(ticks1[1] - ticks0[1]) / all_ticks:.4f}",
          file=sys.stderr)

    found = guard.forbidden_modules()
    if found:
        raise ImportError(f"the JAX package was loaded: {found}")
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.entry["chips"],
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if on_card else 0}
    result = {"attempted": len(calls), "failed": sum(not c["ok"] for c in calls)}
    t_after = time.perf_counter()
    if trace:
        spans = tr.device_spans(tr.records(prof)) if prof is not None else []
        busy_s = tr.busy_us(spans) / 1e6
        device_info.update(busy_s=busy_s, window_s=window_s)
        ctx = SimpleNamespace(cell=cell, calls=[c for c in calls if c["ok"]], spans=spans, busy_s=busy_s, window_s=window_s)
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        gaps = []
        if on_card:
            with tr.profiled(cpu=True) as slice_prof:
                driver.slice_call(state)
            gaps = tr.idle_gaps(tr.records(slice_prof))
        result["breakdown"] = {"device_ops": tr.top_ops(spans), "idle_gaps": gaps}
        _phase("trace reading", time.perf_counter() - t_after, f"{len(spans)} device operations")
    else:
        metrics = end_to_end(cell, calls, setup_s)
    if on_card:
        device_info["power_limit_w"] = _power_limit()
    ok_calls = [c for c in calls if c["ok"]]
    t_check = time.perf_counter()
    checks = driver.check(state, ok_calls, cell.mix["limits"]) if ok_calls else []
    _phase("check", time.perf_counter() - t_check)
    correct = bool(ok_calls) and result["failed"] == 0 and all(v <= lim for _, v, lim in checks)
    result = {"correct": correct, **result, "metrics": metrics, "device": device_info}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    lines = [f"check {name}: {v} (limit {lim})" for name, v, lim in checks]
    return result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--sample-seed", type=int, default=0)
    args = p.parse_args(argv)
    from benchmark.lib import generator

    generator.SAMPLE_SEED = args.sample_seed
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    cell = spec.Cell(spec.load_benchmark(), args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.entry['chips']} CUDA card(s), found {n}", file=sys.stderr)
        return 3
    result, lines = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"))
    found = guard.forbidden_modules()
    if found:
        print(f"benchmark: the JAX package was loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
