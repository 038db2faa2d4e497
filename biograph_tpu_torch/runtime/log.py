"""Structured logging and progress reporting (torch port).

Counterpart of ``biograph_tpu/runtime/log.py`` (the reference's SPLOG and
progress_handler, modules/io/log.h:13-24, modules/io/progress.h): one
module-level logger (timestamped, level-tagged, optionally teed to a file)
and a Progress tree whose stages report fraction and wall time.

``maybe_profile(tag, out_dir)`` is the JAX package's per-command device
trace with an argument where that package reads ``BGT_PROFILE_DIR``: a
``torch.profiler`` trace of the block, host and device, written as a
Chrome trace to ``<out_dir>/<tag>.json`` (Perfetto, ``chrome://tracing``).
While it is open, ``tracing`` is true and each kernel wrapper of ``ops/``
marks its calls as ranges named ``bgt::<wrapper>``.  The log level is an
argument, not the ``BGT_LOG_LEVEL`` variable.
"""

from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import IO, Optional

_LEVELS = {"DEBUG": 10, "INFO": 20, "WARN": 30, "ERROR": 40}


class Logger:
    """Timestamped line logger, tee-able to a file (create_log.txt analog)."""

    def __init__(self, name: str = "bgt", level: str = "INFO"):
        self.name = name
        self.level = _LEVELS[level]
        self._file: Optional[IO] = None

    def tee_to(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._file = open(path, "a")
        return self

    def close(self):
        if self._file:
            self._file.close()
            self._file = None

    def _emit(self, level: str, msg: str, **fields):
        if _LEVELS[level] < self.level:
            return
        t = time.strftime("%Y-%m-%d %H:%M:%S")
        extra = " " + " ".join(f"{k}={v}" for k, v in fields.items()) if fields else ""
        line = f"{t} [{level}] {self.name}: {msg}{extra}"
        print(line, file=sys.stderr if level in ("WARN", "ERROR") else sys.stdout)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()

    def debug(self, msg, **f):
        self._emit("DEBUG", msg, **f)

    def info(self, msg, **f):
        self._emit("INFO", msg, **f)

    def warn(self, msg, **f):
        self._emit("WARN", msg, **f)

    def error(self, msg, **f):
        self._emit("ERROR", msg, **f)


LOG = Logger()

RANGE_PREFIX = "bgt::"  # the kernel wrappers' ranges in a trace
tracing = False  # a maybe_profile trace is open; set by maybe_profile alone


@contextmanager
def maybe_profile(tag: str, out_dir: Optional[str] = None, process_id: Optional[int] = None):
    """Trace the block into ``<out_dir>/<tag>.json`` (``<tag>.p<process_id>
    .json`` for one process of several): ``torch.profiler`` over the host
    and, where CUDA is available, the device, the block one range named
    ``tag``.  Without ``out_dir`` it does nothing.  Inside an open trace it
    only adds the range: the profiler does not nest.  The device is drained
    before the trace stops, so the block's last kernels are in it; a block
    that raises stops the profiler and writes nothing."""
    global tracing
    if out_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if tracing:
        with record_function(tag):
            yield
        return
    name = tag if process_id is None else f"{tag}.p{process_id}"
    path = os.path.join(out_dir, name + ".json")
    os.makedirs(out_dir, exist_ok=True)
    # CUDA is asked for whether or not the block has touched the card yet:
    # a command initialises CUDA inside its trace
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    tracing = True
    try:
        with record_function(tag):
            yield
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    finally:
        tracing = False
        prof.stop()
    prof.export_chrome_trace(path)
    print(f"trace of {tag} -> {path}", file=sys.stderr)  # stdout may be a command's output


@dataclass
class Progress:
    """A stage-progress tree (progress_handler_t + subprogress analog).

    Stages report set(fraction); timings collect into a dict suitable for
    qc/timings.json.  Rendering is rate-limited to avoid log spam."""

    label: str = "run"
    logger: Logger = field(default_factory=lambda: LOG)
    min_interval_s: float = 2.0
    _t0: float = field(default_factory=time.time)
    _last_print: float = 0.0
    timings: dict = field(default_factory=dict)
    # runtime_stats analog (modules/io/runtime_stats.h:14-50): per-stage
    # wall + cpu_user + cpu_sys + end_time, plus free-form counters
    stages: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)

    @contextmanager
    def stage(self, name: str, weight: float = 1.0):
        sub = _Stage(self, name)
        t0 = time.time()
        c0 = os.times()
        self.logger.info(f"{self.label}/{name}: start")
        try:
            yield sub
        finally:
            dt = time.time() - t0
            c1 = os.times()
            self.timings[name] = round(dt, 3)
            self.stages.append(
                {
                    "name": name,
                    "end_time": int(time.time()),
                    "wall_seconds": round(dt, 3),
                    "cpu_user_seconds": round(c1.user - c0.user, 3),
                    "cpu_sys_seconds": round(c1.system - c0.system, 3),
                }
            )
            self.logger.info(f"{self.label}/{name}: done", seconds=round(dt, 2))

    def add(self, name: str, value):
        """Record a named stat (runtime_stats::add analog)."""
        self.counters[name] = value

    def count(self, name: str, delta: int = 1):
        """Bump a counter (autostats counter analog)."""
        self.counters[name] = self.counters.get(name, 0) + delta

    def save_timings(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.timings, f, indent=1)

    def stats_dict(self) -> dict:
        """The qc/create_stats.json payload (runtime_stats::save analog)."""
        return {"stages": self.stages, **({"counters": self.counters} if self.counters else {})}


class _Stage:
    def __init__(self, parent: Progress, name: str):
        self.parent = parent
        self.name = name

    def set(self, fraction: float, detail: str = ""):
        now = time.time()
        if now - self.parent._last_print < self.parent.min_interval_s:
            return
        self.parent._last_print = now
        pct = min(max(fraction, 0.0), 1.0) * 100
        msg = f"{self.parent.label}/{self.name}: {pct:.0f}%"
        if detail:
            msg += f" ({detail})"
        self.parent.logger.info(msg)
