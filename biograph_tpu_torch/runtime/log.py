"""Structured logging, progress reporting and the span recorder (torch port).

Counterpart of ``biograph_tpu/runtime/log.py`` (the reference's SPLOG and
progress_handler, modules/io/log.h:13-24, modules/io/progress.h): one
module-level logger (timestamped, level-tagged, optionally teed to a file)
and a Progress record of stages with their wall and CPU time.

The span recorder: ``span(name, **counts)`` marks a block of the program,
``add_span`` records one already finished (a stage clock's mark),
``count(**counts)`` adds to the innermost open span's counts (counts of one
name add up), and ``take_spans()`` hands over what was recorded.  A span
holds its name, its start and end in ``time.time_ns()`` nanoseconds (the
clock the profiler stamps its events with, so spans lie on a trace's
timeline), the index of its parent and a few integer counts.  The
recorder is on exactly while a profiler runs (``tracing()``, whoever
started it); off, a span costs that one check and records nothing.

``maybe_profile(tag, out_dir)`` is the JAX package's per-command device
trace with an argument where that package reads ``BGT_PROFILE_DIR``: a
``torch.profiler`` trace of the block, host and device, written as a
Chrome trace to ``<out_dir>/<tag>.json`` (Perfetto, ``chrome://tracing``).
While any profiler runs each kernel wrapper of ``ops/`` records its calls
as spans named after it, and ``maybe_profile`` writes the block's spans
into its file as ranges ``bgt::<span>`` (``bgt::push4``,
``bgt::discover.call``, ...).  The log level is an argument, not the
``BGT_LOG_LEVEL`` variable.
"""

from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import IO, NamedTuple, Optional

import torch

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

RANGE_PREFIX = "bgt::"  # the spans' ranges in a maybe_profile trace

# the recorder's one switch: a profiler runs
tracing = torch.autograd._profiler_enabled


class Span(NamedTuple):
    """One recorded span: ``name``, ``start_ns`` and ``end_ns``
    (``time.time_ns()``), ``parent`` (the index of the span it lies in among
    the same recording, -1 for none) and ``counts`` (name -> int)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    counts: dict


# The recording, in columns of strings and ints, in order of recording (one
# thread's): a span leaves no object behind that the interpreter's cyclic
# collector tracks, so recording does not set the collector off in the
# middle of a call (one retained object a span did, at a cost of tenths of a
# second a collection in discovery's windows).  Counts are (span, name,
# value) rows.
_name: list = []
_start: list = []
_end: list = []  # 0 while the span is open
_parent: list = []
_count_span: list = []
_count_name: list = []
_count_value: list = []
_open: list = []  # indices of the spans open now, innermost last


def _record(name: str, start_ns: int, end_ns: int, counts: dict) -> int:
    i = len(_name)
    _name.append(name)
    _start.append(start_ns)
    _end.append(end_ns)
    _parent.append(_open[-1] if _open else -1)
    _count(i, counts)
    return i


def _count(i: int, counts: dict) -> None:
    for k, v in counts.items():
        _count_span.append(i)
        _count_name.append(k)
        _count_value.append(v)


class _On:
    """What ``span`` gives while a profiler runs: the context manager of one
    span, which stamps its start and end; ``set`` adds counts."""

    __slots__ = ("i",)

    def __init__(self, name: str, counts: dict):
        self.i = _record(name, 0, 0, counts)

    def __enter__(self):
        _open.append(self.i)
        _start[self.i] = time.time_ns()
        return self

    def __exit__(self, *exc):
        _end[self.i] = time.time_ns()
        _open.pop()
        return False

    def set(self, **counts) -> None:
        _count(self.i, counts)


class _Off:
    """What ``span`` gives while no profiler runs: it records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **counts) -> None:
        pass


_OFF = _Off()


def span(name: str, **counts):
    """A context manager marking the block as the span ``name`` with
    ``counts``, inside the innermost open span; records nothing while no
    profiler runs."""
    if not tracing():
        return _OFF
    return _On(name, counts)


def count(**counts) -> None:
    """Add ``counts`` to the innermost open span, while a profiler runs."""
    if _open and tracing():
        _count(_open[-1], counts)


def add_span(name: str, start_ns: int, end_ns: int, **counts) -> None:
    """Record a finished span, inside the innermost open one, while a
    profiler runs.  The spans of the same parent recorded inside its
    interval become its children."""
    if not tracing():
        return
    i = _record(name, start_ns, end_ns, counts)
    j = i
    while j > 0 and _start[j - 1] >= start_ns:
        j -= 1
        if _parent[j] == _parent[i] and _end[j] <= end_ns:
            _parent[j] = i


def _spans(first: int = 0) -> list:
    """The recording from index ``first`` on, as ``Span``s."""
    counts = [{} for _ in range(len(_name) - first)]
    for i, k, v in zip(_count_span, _count_name, _count_value):
        if i >= first:
            counts[i - first][k] = counts[i - first].get(k, 0) + v
    return [Span(*row, c) for row, c in zip(zip(_name[first:], _start[first:], _end[first:], _parent[first:]), counts)]


def take_spans() -> list:
    """The spans recorded so far (``Span``s in order of recording, a
    parent's index into this list), and a fresh recording; no span may be
    open."""
    if _open:
        raise RuntimeError(f"take_spans: {len(_open)} span(s) still open")
    out = _spans()
    for column in (_name, _start, _end, _parent, _count_span, _count_name, _count_value):
        column.clear()
    return out


def _write_spans(path: str, tag: str, spans: list) -> None:
    """Add ``spans`` to the Chrome trace at ``path`` as ranges
    ``bgt::<name>`` on the thread of its range ``tag``, their counts as the
    ranges' arguments.  The trace's times are microseconds after its
    ``baseTimeNanoseconds`` (0 where it has none), on the spans' clock."""
    if not spans:
        return
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    top = max((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") == tag),
              key=lambda e: e["dur"])
    base = trace.get("baseTimeNanoseconds", 0)
    for s in spans:
        events.append({"ph": "X", "cat": "user_annotation", "name": RANGE_PREFIX + s.name, "pid": top["pid"],
                       "tid": top["tid"], "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": dict(s.counts)})
    with open(path, "w") as f:
        json.dump(trace, f)


@contextmanager
def maybe_profile(tag: str, out_dir: Optional[str] = None, process_id: Optional[int] = None):
    """Trace the block into ``<out_dir>/<tag>.json`` (``<tag>.p<process_id>
    .json`` for one process of several): ``torch.profiler`` over the host
    and, where CUDA is available, the device, the block one range named
    ``tag`` and each span recorded in it a range ``bgt::<span>``.  Without
    ``out_dir`` it does nothing.  While a profiler runs it only adds the
    range: the profiler does not nest.  The device is drained before the
    trace stops, so the block's last kernels are in it; a block that raises
    stops the profiler and writes nothing."""
    if out_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    if tracing():
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
    first = len(_name)
    try:
        with record_function(tag):
            yield
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    finally:
        prof.stop()
    prof.export_chrome_trace(path)
    _write_spans(path, tag, _spans(min(first, len(_name))))
    print(f"trace of {tag} -> {path}", file=sys.stderr)  # stdout may be a command's output


@dataclass
class Progress:
    """The stages of a command (progress_handler_t + runtime_stats analog,
    modules/io/runtime_stats.h:14-50): per stage wall, cpu_user, cpu_sys and
    end_time, logged at each stage's start and end, plus free-form
    counters; ``stats_dict`` is qc/create_stats.json's payload."""

    label: str = "run"
    logger: Logger = field(default_factory=lambda: LOG)
    timings: dict = field(default_factory=dict)
    stages: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)

    @contextmanager
    def stage(self, name: str):
        t0 = time.time()
        c0 = os.times()
        self.logger.info(f"{self.label}/{name}: start")
        try:
            yield
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

    def stats_dict(self) -> dict:
        """The qc/create_stats.json payload (runtime_stats::save analog)."""
        return {"stages": self.stages, **({"counters": self.counters} if self.counters else {})}
