"""The guard against the JAX package, by whole top-level names."""

import subprocess
import sys

from benchmark.lib import guard
from benchmark.lib.spec import ROOT


def test_forbidden_by_whole_top_level_name():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1, "biograph_tpu": 1, "biograph_tpu.core": 1,
            "biograph_tpu_torch": 1, "biograph_tpu_torch.core": 1, "jaxtyping": 1, "numpy": 1}
    assert guard.forbidden_modules(mods) == ["biograph_tpu", "biograph_tpu.core", "flax", "jax", "jax.numpy", "jaxlib.xla"]
    assert guard.forbidden_modules({"biograph_tpu_torch.variants.discover": 1}) == []


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """In a fresh process: the harness, every driver and the port's modules
    that the drivers call."""
    code = (
        "import sys, importlib; sys.path.insert(0, %r)\n"
        "from benchmark.lib import spec, guard, discovery_check, reference, control, trace\n"
        "bench = spec.load_benchmark()\n"
        "for w in bench['workloads']: spec.Cell(bench, w['name']).driver()\n"
        "import biograph_tpu_torch.variants.discover, biograph_tpu_torch.build.seqset_build\n"
        "import biograph_tpu_torch.build.readmap_build, biograph_tpu_torch.runtime.resources\n"
        "print(guard.forbidden_modules())\n"
    ) % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
