"""Per-position probe ranges, chain subset (torch).

Counterpart of ``biograph_tpu/index/probes.py`` for the find-window chain:
the state at text position j is the seqset range of a window ending at j,
so every position is a lane and the sequential depth is the probe depth.

Windows are pushed complemented (ranges live in reverse-complement space so
extending rightward is a push_front).  Existence is monotone in the window
length (the seqset holds every suffix of every read), so ``probe_exact``
finds the longest existing window by binary search, each test one find
chain.

``find_window`` / ``probe_exact`` are the plain path (a loop of push_front
steps); ``find_window_auto`` / ``probe_exact_kernel`` run each chain as one
launch of the ``chain_window`` kernel when the seqset is on the card.
``probe_ranges``, the walk variants and the hash probes are not ported yet.

``text`` is a uint8 code tensor (a doubled fwd++rc reference, or flattened
query rows); ``seg_lo`` (scalar or per-lane) clips each window's left edge.
"""

from __future__ import annotations

import torch

from biograph_tpu_torch.index.seqset import SeqsetRanges
from biograph_tpu_torch.ops.rank4 import chain_window


def _window_bases(text: torch.Tensor, pos: torch.Tensor, depth: int) -> torch.Tensor:
    """Pre-gathered complemented per-lane base matrix, uint8 [P, depth]:
    row j holds 3 - text[pos[j] - depth + 1 + s] for s in [0, depth), the
    index clipped into the text.  ONE gather reused by every step and every
    binary-search round."""
    n2 = text.shape[0]
    idx = (
        pos.to(torch.int64)[:, None]
        - (depth - 1)
        + torch.arange(depth, dtype=torch.int64, device=text.device)[None, :]
    ).clamp(0, n2 - 1)
    return (3 - text[idx]).to(torch.uint8)


def _start(d, P: int):
    dev = d.device
    return (
        torch.zeros(P, dtype=torch.int64, device=dev),
        torch.full((P,), d.n_entries, dtype=torch.int64, device=dev),
        torch.zeros(P, dtype=torch.int32, device=dev),
    )


def find_window(d, text, pos, m, depth: int):
    """Range of the length-m window ending at each pos (masked find chain).

    The push index at step s is pos - (depth-1) + s regardless of m; only
    the start mask differs, so every chain shape is identical."""
    n2 = text.shape[0]
    pos = pos.to(torch.int64)
    m = torch.as_tensor(m, device=d.device)
    begin, end, size = _start(d, pos.shape[0])
    for s in range(depth):
        idx = (pos - (depth - 1) + s).clamp(0, n2 - 1)
        b = (3 - text[idx]).to(torch.int64)
        started = s >= (depth - m)
        r2 = d.push_front(SeqsetRanges(begin, end, size), b)
        begin = torch.where(started, r2.begin, begin)
        end = torch.where(started, r2.end, end)
        size = torch.where(started, r2.size, size)
    return begin, end, size


def _chain(d, win, m, depth: int):
    return chain_window(
        d.rank_blocks, d.entry_sizes, d.fixed, win,
        m.to(torch.int32).contiguous(), depth,
    )


def find_window_auto(d, text, pos, m, depth: int):
    """``find_window`` with the whole chain in one kernel launch."""
    P = pos.shape[0]
    m = torch.as_tensor(m, device=d.device).to(torch.int32).expand(P)
    return _chain(d, _window_bases(text, pos, depth), m, depth)


def _bracket(pos, seg_lo, depth: int, min_m: int):
    w0 = torch.clamp(pos - seg_lo + 1, max=depth).to(torch.int32)
    lo_m = torch.clamp(w0, max=min_m) if min_m else torch.zeros_like(w0)
    return lo_m, w0


def _rounds(depth: int, min_m: int) -> int:
    if min_m:
        return (depth - min_m).bit_length()
    return max((depth - 1).bit_length(), 1)


def _exact_mid(lo_m, hi_m):
    return torch.where(hi_m - lo_m > 1, (lo_m + hi_m) // 2, lo_m)


def _exact_round(lo_m, hi_m, mid, bb, be, bs, b, e, s):
    found = b < e
    ok = found & (mid > lo_m)
    return (
        torch.where(ok, mid, lo_m),
        torch.where(found, hi_m, torch.minimum(mid, hi_m)),
        torch.where(ok, b, bb),
        torch.where(ok, e, be),
        torch.where(ok, s, bs),
    )


def _probe_exact(d, pos, seg_lo, depth, min_m, seed, find):
    """Binary search on the window length; ``find(m)`` runs one chain."""
    pos = pos.to(torch.int64)
    seg_lo = torch.as_tensor(seg_lo, device=pos.device)
    lo_m, hi_m = _bracket(pos, seg_lo, depth, min_m)
    # best-so-far range: lo_m only moves on a successful test, so the last
    # successful chain's range IS the final answer — no closing find needed
    bb, be, bs = _start(d, pos.shape[0])
    if min_m:
        # the caller asserted EXISTS(min_m); seed best-so-far with it so a
        # bracket that never improves still returns a valid range
        bb, be, bs = seed if seed is not None else find(lo_m)
    for _ in range(_rounds(depth, min_m)):
        mid = _exact_mid(lo_m, hi_m)
        b, e, s = find(mid)
        lo_m, hi_m, bb, be, bs = _exact_round(
            lo_m, hi_m, mid, bb, be, bs, b, e, s
        )
    return bb, be, bs


def probe_exact(d, text, pos, seg_lo, depth: int, min_m: int = 0, seed=None):
    """Exact longest-window probe: the range of the longest window ending
    at each pos that exists in the seqset, searched over lengths in
    [min_m, w0) with w0 = min(depth, pos - seg_lo + 1).  The upper end is
    exclusive: callers probe lanes whose full-length window is already
    known to be absent.

    EXISTS(m) is monotone, so at most ceil(log2(depth)) rounds of find
    chains pin the length down.  min_m > 0 narrows the search for callers
    that pre-filtered lanes with find_window(min_m) (pass that chain's
    result as ``seed`` to skip recomputing it)."""
    return _probe_exact(
        d, pos, seg_lo, depth, min_m, seed,
        lambda m: find_window(d, text, pos, m, depth),
    )


def probe_exact_kernel(d, text, pos, seg_lo, depth: int, min_m: int = 0,
                       seed=None):
    """``probe_exact`` with every binary-search round's find chain as ONE
    kernel launch, all rounds reusing one window gather."""
    win = _window_bases(text, pos, depth)
    return _probe_exact(
        d, pos, seg_lo, depth, min_m, seed,
        lambda m: _chain(d, win, m, depth),
    )
