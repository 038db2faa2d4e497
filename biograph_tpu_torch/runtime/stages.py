"""Resumable stage runner: the control plane of the pipeline.

Counterpart of ``biograph_tpu/runtime/stages.py`` (in place of the
reference's task framework, modules/mapred/task.h:45, its task database,
taskdb.h:18, and job resurrection, main/resurrect.cpp):

  * each stage is a function from input artifacts to immutable output
    artifacts;
  * a JSON run manifest records each stage's status, timings and attempts;
  * ``resume`` skips completed stages (``full_pipeline --resume``); a failed
    stage is retried up to ``max_attempts`` (worker.cpp:67 max_errors);
  * ``rerun`` forces one stage again and keeps every other stage's output.

Stages run one after another in this process; each stage's device work is
its own.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List

from biograph_tpu_torch.runtime import storage


@dataclass
class Stage:
    name: str
    fn: Callable[["StageRunner"], None]
    outputs: List[str] = field(default_factory=list)  # artifact paths
    max_attempts: int = 2
    # resource class, recorded in the manifest for schedulers above: "device"
    # stages own the accelerator, "host" stages are CPU or IO bound
    profile: str = "device"


class StageError(RuntimeError):
    pass


@dataclass
class ArtifactInfo:
    """One dataset entry of the run manifest (mapred/manifest.h:20): path,
    bytes, record count and content identity."""

    path: str
    bytes: int = 0
    records: int = 0
    uuid: str = ""

    @staticmethod
    def describe(path: str, records: int = 0, uuid: str = "") -> "ArtifactInfo":
        total = 0
        if os.path.isdir(path):
            for root, _, files in os.walk(path):
                for fn in files:
                    total += os.path.getsize(os.path.join(root, fn))
            if not uuid:
                meta = os.path.join(path, "artifact.json")
                if os.path.isfile(meta):
                    try:
                        with open(meta) as f:
                            uuid = json.load(f).get("uuid", "")
                    except (OSError, ValueError):
                        pass
        elif os.path.isfile(path):
            total = os.path.getsize(path)
        return ArtifactInfo(path=path, bytes=total, records=records, uuid=uuid)


class StageRunner:
    def __init__(self, run_dir: str, resume: bool = True):
        # run_dir may carry a storage scheme: the manifest and the done
        # checks resolve through runtime/storage
        self.run_dir = run_dir
        self.storage = storage.for_path(run_dir)
        self.storage.makedirs(run_dir)
        self.manifest_path = storage.join(run_dir, "run_manifest.json")
        self.resume = resume
        self.manifest: Dict = {"stages": {}, "created": _now()}
        if resume and self.storage.exists(self.manifest_path):
            self.manifest = storage.read_json(self.manifest_path)
        self.context: Dict = {}

    def _save(self):
        storage.write_json_atomic(self.manifest_path, self.manifest)

    def _outputs_exist(self, stage: Stage) -> bool:
        return bool(stage.outputs) and all(storage.for_path(p).exists(p) for p in stage.outputs)

    def _stage_done(self, stage: Stage) -> bool:
        rec = self.manifest["stages"].get(stage.name)
        if not rec or rec.get("status") != "done":
            return False
        return all(storage.for_path(p).exists(p) for p in stage.outputs)

    def run(self, stages: List[Stage], stop_after: str | None = None, rerun: str | None = None, verbose: bool = False):
        """Run stages in order with resume and bounded retries.

        rerun: force exactly this stage to run again while every other
        stage with existing outputs is skipped.  Returns stop_after if that
        stage was reached and run, else None."""
        for stage in stages:
            if rerun and stage.name != rerun and self._outputs_exist(stage):
                if verbose:
                    print(f"[{stage.name}] exists, skipping (--rerun {rerun})")
                continue
            if not rerun and self.resume and self._stage_done(stage):
                if verbose:
                    first = stage.outputs[0] if stage.outputs else ""
                    print(f"[{stage.name}] exists, skipping ({first})")
                continue
            if rerun == stage.name:
                self.manifest["stages"].pop(stage.name, None)  # fresh attempts
            rec = self.manifest["stages"].setdefault(stage.name, {"attempts": 0})
            ok = False
            while rec["attempts"] < stage.max_attempts and not ok:
                rec["attempts"] += 1
                rec["status"] = "running"
                rec["started"] = _now()
                self._save()
                t0 = time.time()
                try:
                    stage.fn(self)
                    ok = True
                except Exception:
                    rec["status"] = "failed"
                    rec["error"] = traceback.format_exc().splitlines()[-1]
                    self._save()
            if not ok:
                raise StageError(f"stage {stage.name!r} failed after {rec['attempts']} attempts: {rec.get('error')}")
            rec["status"] = "done"
            rec["profile"] = stage.profile
            rec["wall_s"] = round(time.time() - t0, 3)
            rec["finished"] = _now()
            rec["outputs"] = [vars(ArtifactInfo.describe(p)) for p in stage.outputs]
            self._save()
            if stop_after == stage.name:
                return stage.name
        return None

    def register_artifact(self, name: str, path: str, records: int = 0, uuid: str = ""):
        """Add a named dataset to the run manifest."""
        ds = self.manifest.setdefault("datasets", {})
        ds[name] = vars(ArtifactInfo.describe(path, records=records, uuid=uuid))
        self._save()


def _now():
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
