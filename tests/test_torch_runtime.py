"""The port's control plane (``biograph_tpu_torch/runtime``: ``stages.py``,
``storage.py``, ``config.py``) against the JAX package's.

``tests/test_stages.py``'s and ``tests/test_storage.py``'s cases run on
both packages' modules, which must call the same stages in the same order
and write manifests with the same keys; a custom storage scheme carries a
whole run; ``apply_options`` resolves its layers (defaults < a product
dict < ``--opt``), raises on an unknown field, and gives the JAX package's
answer for the layers both have.  No tensor is involved.
"""

import io
import json
import os

import numpy as np
import pytest

from biograph_tpu.runtime import stages as jstages
from biograph_tpu.runtime import storage as jstorage
from biograph_tpu_torch.runtime import config as tconfig
from biograph_tpu_torch.runtime import stages as tstages
from biograph_tpu_torch.runtime import storage as tstorage

PACKAGES = {"jax": jstages, "torch": tstages}


def _recording_stages(mod, run, names, calls):
    def mk(name):
        out = os.path.join(run, name + ".out")

        def fn(r):
            calls.append(name)
            with open(out, "w") as f:
                f.write(name)

        return mod.Stage(name=name, fn=fn, outputs=[out])

    return [mk(n) for n in names]


def _run_and_resume(mod, run):
    """tests/test_stages.py::test_stages_run_and_resume, plus --rerun:
    the stages each run of the scenario called."""
    calls, seen = [], []
    stages = _recording_stages(mod, run, ("a", "b", "c"), calls)
    for step in ("cold", "resume", "lost b", "rerun c"):
        calls.clear()
        if step == "lost b":
            os.remove(os.path.join(run, "b.out"))
        mod.StageRunner(run).run(stages, rerun="c" if step == "rerun c" else None)
        seen.append((step, list(calls)))
    with open(os.path.join(run, "run_manifest.json")) as f:
        manifest = json.load(f)
    return seen, manifest


def test_stages_run_resume_rerun_as_jax(tmp_path):
    want, jman = _run_and_resume(jstages, str(tmp_path / "jax"))
    got, tman = _run_and_resume(tstages, str(tmp_path / "torch"))
    assert got == want == [("cold", ["a", "b", "c"]), ("resume", []), ("lost b", ["b"]), ("rerun c", ["c"])]
    assert tman.keys() == jman.keys() and tman["stages"].keys() == jman["stages"].keys()
    for name in tman["stages"]:
        assert tman["stages"][name].keys() == jman["stages"][name].keys()
        assert tman["stages"][name]["status"] == "done" and tman["stages"][name]["attempts"] == jman["stages"][name]["attempts"]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_stage_retry_failure_and_stop_after(tmp_path, pkg):
    mod = PACKAGES[pkg]
    run = str(tmp_path / "run")
    attempts = {"n": 0}

    def flaky(r):
        attempts["n"] += 1
        if attempts["n"] < 2:
            raise RuntimeError("transient")
        with open(os.path.join(run, "f.out"), "w") as f:
            f.write("ok")

    mod.StageRunner(run).run([mod.Stage("flaky", flaky, outputs=[os.path.join(run, "f.out")], max_attempts=3)])
    assert attempts["n"] == 2

    def always_fails(r):
        raise RuntimeError("boom")

    with pytest.raises(mod.StageError, match="boom"):
        mod.StageRunner(str(tmp_path / "run2")).run([mod.Stage("bad", always_fails, max_attempts=2)])
    calls = []
    stages = [mod.Stage(n, (lambda n: lambda r: calls.append(n))(n)) for n in ("x", "y", "z")]
    assert mod.StageRunner(str(tmp_path / "run3")).run(stages, stop_after="y") == "y"
    assert calls == ["x", "y"]


def test_artifact_manifest_and_profiles(tmp_path):
    out1 = tmp_path / "a.bin"

    def make(runner):
        out1.write_bytes(b"x" * 100)
        runner.register_artifact("reads", str(out1), records=10)

    manifests = []
    for name, mod in sorted(PACKAGES.items()):
        run = tmp_path / name
        mod.StageRunner(str(run), resume=True).run([mod.Stage("make", make, outputs=[str(out1)], profile="host")])
        with open(run / "run_manifest.json") as f:
            manifests.append(json.load(f))
        assert mod.ArtifactInfo.describe(str(out1)).bytes == 100
    for m in manifests:
        assert m["stages"]["make"]["profile"] == "host" and m["stages"]["make"]["outputs"][0]["bytes"] == 100
        assert m["datasets"]["reads"]["records"] == 10
    assert manifests[0]["datasets"] == manifests[1]["datasets"]
    whole = vars(tstages.ArtifactInfo.describe(str(tmp_path)))
    assert whole == vars(jstages.ArtifactInfo.describe(str(tmp_path))) and whole["bytes"] > 100


class MemStorage(tstorage.Storage):
    """A dict-backed object store."""

    def __init__(self, blobs):
        self.blobs = blobs

    def open(self, path, mode="r"):
        if "r" in mode:
            data = self.blobs[path]
            return io.BytesIO(data) if "b" in mode else io.StringIO(data.decode())
        blobs = self.blobs
        buf = io.BytesIO() if "b" in mode else io.StringIO()

        class _W:
            def __enter__(self):
                return buf

            def __exit__(self, *exc):
                if not any(exc):
                    data = buf.getvalue()
                    blobs[path] = data.encode() if isinstance(data, str) else data

        return _W()

    def exists(self, path):
        return path in self.blobs

    def makedirs(self, path):
        pass

    def publish(self, tmp, dst):
        self.blobs[dst] = self.blobs.pop(tmp)

    def listdir(self, path):
        pre = path.rstrip("/") + "/"
        return [k[len(pre):] for k in self.blobs if k.startswith(pre)]


@pytest.fixture
def mem():
    blobs = {}
    tstorage.register_scheme("mem", lambda: MemStorage(blobs))
    yield blobs
    tstorage._SCHEMES.pop("mem", None)
    tstorage._CACHE.pop("mem", None)


def test_scheme_dispatch_and_json_roundtrip(mem):
    path = "mem://bucket/a/b.json"
    tstorage.write_json_atomic(path, {"x": 1})
    assert tstorage.read_json(path) == {"x": 1}
    assert not any(k.endswith(".tmp") for k in mem)  # publish consumed the tmp blob
    for p in (path, "/plain/path", "file:///x/y"):
        assert tstorage.scheme_of(p) == jstorage.scheme_of(p)
    for base, part in (("mem://b/dir", "f.txt"), ("/a/b", "c")):
        assert tstorage.join(base, part) == jstorage.join(base, part)
    assert tstorage.join("mem://b/dir/", "f.txt") == "mem://b/dir/f.txt"
    with pytest.raises(ValueError, match="unknown storage scheme"):
        tstorage.for_path("gs://nope/x")


def test_stage_runner_on_custom_scheme(mem):
    """The port's StageRunner runs a two-stage pipeline against the
    registered backend alone: manifest, resume and done checks."""
    run_dir = "mem://runs/r1"
    calls = []

    def s1(runner):
        calls.append("s1")
        with tstorage.for_path(run_dir).open(tstorage.join(run_dir, "one.txt"), "w") as f:
            f.write("hello")

    stages = [
        tstages.Stage(name="one", fn=s1, outputs=[tstorage.join(run_dir, "one.txt")]),
        tstages.Stage(name="two", fn=lambda r: calls.append("s2")),
    ]
    tstages.StageRunner(run_dir, resume=False).run(stages)
    assert calls == ["s1", "s2"]
    assert tstorage.read_json(tstorage.join(run_dir, "run_manifest.json"))["stages"]["one"]["status"] == "done"
    tstages.StageRunner(run_dir, resume=True).run(stages)
    assert calls == ["s1", "s2"]  # both done: resume skips them
    assert sorted(tstorage.for_path(run_dir).listdir(run_dir)) == ["one.txt", "run_manifest.json"]


def test_local_storage_binary_npz(tmp_path):
    st = tstorage.for_path("file://" + str(tmp_path))
    p = tstorage.join(str(tmp_path), "x.npz")
    with st.open(p + ".tmp", "wb") as f:
        np.savez(f, a=np.arange(5))
    st.publish(p + ".tmp", p)
    with st.open(p, "rb") as f:
        np.testing.assert_array_equal(dict(np.load(f))["a"], np.arange(5))
    assert st.exists(p) and not st.exists(p + ".tmp") and st.listdir(str(tmp_path)) == ["x.npz"]


def test_s3_unavailable_is_a_clear_error():
    try:
        import boto3  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="boto3"):
            tstorage.for_path("s3://bucket/key")
    tstorage._CACHE.pop("s3", None)


def test_apply_options_layers():
    """defaults < product dict < --opt; the product's unknown keys are
    skipped, an unknown --opt field raises; the CLI layer alone gives the
    JAX package's answer."""
    from biograph_tpu.runtime.config import apply_options as japply
    from biograph_tpu.variants.discover import DiscoverOptions as JOpt
    from biograph_tpu_torch.variants.discover import DiscoverOptions
    from biograph_tpu_torch.variants.pop_tracer import SvOptions

    opt = DiscoverOptions()
    default_rejoin = opt.rejoin_k
    applied = tconfig.apply_options(opt, ["max_path=300", "bidir=false"], product={"beam_width": 64, "max_path": 100, "min_run": 5})
    assert opt.beam_width == 64 and opt.max_path == 300 and opt.bidir is False and opt.rejoin_k == default_rejoin
    assert applied == {"beam_width": (64, "product"), "max_path": (300, "cli"), "bidir": (False, "cli")}
    sv = SvOptions()
    assert tconfig.apply_options(sv, product={"beam_width": 64, "min_run": 25}) == {"min_run": (25, "product")} and sv.min_run == 25
    with pytest.raises(ValueError, match="unknown option 'no_such_knob'"):
        tconfig.apply_options(DiscoverOptions(), ["no_such_knob=1"])
    with pytest.raises(ValueError, match="field=value"):
        tconfig.apply_options(DiscoverOptions(), ["max_path"])
    overrides = ["rejoin_k=21", "bidir=yes", "max_path=77"]
    got, want = DiscoverOptions(), JOpt()
    assert tconfig.apply_options(got, overrides) == japply(want, overrides)
    assert {k: getattr(got, k) for k in ("rejoin_k", "bidir", "max_path")} == {k: getattr(want, k) for k in ("rejoin_k", "bidir", "max_path")}
