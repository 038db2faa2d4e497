"""Batched affine-gap global alignment (the aligner step; torch).

Counterpart of ``biograph_tpu/ops/align_dp.py``: N (ref, alt) blocks align
at once, the three-state affine DP sweeping the rows in a Python loop while
every lane and every column updates in parallel.

Score model (minimization): mismatch=1, gap open=2.5, gap extend=0.5, the
same as ``variants/discover._align_decompose`` so decompositions agree.

The scores are float64, which is what the JAX package computes in (it runs
with 64-bit types enabled, and its score constants are Python floats).
Every reachable score is a small multiple of 0.5, exact in any float type;
float64 also keeps ``BIG + 2.5`` apart from ``BIG``, so the unreachable
states compare as they do there.  Ties are broken by explicit compares, M
before Ix before Iy, the order ``argmin`` gives in the JAX package.

Returns packed traceback choices so the host can emit SNP/ins/del pieces
without re-running the DP.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from biograph_tpu_torch import resolve_device

MIS = 1.0
GAP_OPEN = 2.5
GAP_EXT = 0.5
BIG = 1e9


def _first_min3(a, b, c):
    """(min, index of the first minimum) of three tensors, elementwise."""
    src = torch.where(b < a, 1, 0)
    best = torch.minimum(a, b)
    src = torch.where(c < best, 2, src)
    return torch.minimum(best, c), src.to(torch.uint8)


def _shift_right(x, fill):
    """x moved one column to the right, ``fill`` entering at column 0."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _align_scores(ref, alt, ref_len, alt_len, Lr: int, La: int):
    """DP over N lanes: returns (packed traceback [N, Lr+1, La+1] uint8,
    final state [N] uint8).

    ref uint8 [N, Lr]; alt uint8 [N, La+1] with the blocks from column 1;
    ref_len, alt_len int64 [N].  Traceback byte: bits 0-1 = M came-from
    state, bit 2 = Ix from extend, bit 3 = Iy from extend."""
    N = ref.shape[0]
    dev = ref.device
    f = torch.float64
    cols = torch.arange(La + 1, device=dev)
    jcol = cols.to(f)[None, :]
    col0 = (cols == 0)[None, :]
    big = torch.full((N, La + 1), BIG, dtype=f, device=dev)
    m = torch.where(col0, 0.0, big)
    ix = big
    iy = torch.where(col0, big, (GAP_OPEN + GAP_EXT * (jcol - 1).clamp(min=0)).expand(N, -1))
    tb = torch.empty((N, Lr + 1, La + 1), dtype=torch.uint8, device=dev)
    tb[:, 0] = 1 << 3  # row 0 has the trivial traceback
    # the final scores are those of row ref_len, taken as the rows go by
    at_end = ref_len == 0
    fm, fx, fy = (torch.where(at_end[:, None], x, big) for x in (m, ix, iy))
    for i in range(1, Lr + 1):
        # Ix (deletion: consume ref row i), from the previous row
        ix_open = m + GAP_OPEN
        ix_ext = ix + GAP_EXT
        ix_from_ext = (ix_ext < ix_open).to(torch.uint8)
        # M needs the diagonal: the previous row moved right
        sub = torch.where(ref[:, i - 1 : i] == alt, 0.0, MIS)
        best, m_src = _first_min3(_shift_right(m, BIG), _shift_right(ix, BIG), _shift_right(iy, BIG))
        ix = torch.minimum(ix_open, ix_ext)
        m = torch.where(col0, BIG, best + sub)
        # Iy (insertion: consume alt col): iy[j] = min(m[j-1]+open,
        # iy[j-1]+ext) unrolled to ext*j + cummin(c)[j] with c[j] = m[j-1] +
        # open - ext*j, a prefix min in place of a La-step scan; from_ext[j]
        # <=> the best opener lies before j-1
        c = _shift_right(m, BIG) + GAP_OPEN - GAP_EXT * jcol
        cm = torch.cummin(c, dim=1).values
        iy = torch.where(col0, BIG, GAP_EXT * jcol + cm)
        iy_from_ext = (_shift_right(cm, BIG) < c).to(torch.uint8)
        tb[:, i] = m_src | (ix_from_ext << 2) | (iy_from_ext << 3)
        at_end = (ref_len == i)[:, None]
        fm, fx, fy = (torch.where(at_end, x, fx_) for x, fx_ in ((m, fm), (ix, fx), (iy, fy)))
    at = alt_len[:, None]
    _, final_state = _first_min3(*(x.gather(1, at)[:, 0] for x in (fm, fx, fy)))
    return tb, final_state


def _pow2(n):
    p = 8
    while p < n:
        p *= 2
    return p


def align_blocks_batch(
    ref_blocks: List[np.ndarray], alt_blocks: List[np.ndarray], device="cuda"
):
    """Align N (ref, alt) code blocks on ``device``; returns per-pair op
    lists.

    ops: list of ('M'|'D'|'I', ref_idx, alt_idx) in order, the same contract
    as the scalar NW in variants/discover.
    """
    N = len(ref_blocks)
    if N == 0:
        return []
    dev = resolve_device(device)
    # bucket by pow2 block size: one long block must not make every short
    # block pay its padded DP (cost is Lr rows x La cols per lane)
    sizes = [max(max(len(r), len(a)), 1) for r, a in zip(ref_blocks, alt_blocks)]
    if N > 1 and max(sizes) > 2 * min(sizes):
        buckets: dict = {}
        for i, sz in enumerate(sizes):
            buckets.setdefault(_pow2(sz), []).append(i)
        if len(buckets) > 1:  # single-bucket sets fall through (no recursion)
            out = [None] * N
            for ids in buckets.values():
                sub = align_blocks_batch(
                    [ref_blocks[i] for i in ids], [alt_blocks[i] for i in ids], dev
                )
                for i, ops in zip(ids, sub):
                    out[i] = ops
            return out
    # pow2 shapes, as the JAX package pads them
    Lr = _pow2(max(max(len(r) for r in ref_blocks), 1))
    La = _pow2(max(max(len(a) for a in alt_blocks), 1))
    ref = np.zeros((N, Lr), np.uint8)
    alt = np.zeros((N, La + 1), np.uint8)  # compared row-wise from column 1
    rl = np.zeros(N, np.int64)
    al = np.zeros(N, np.int64)
    for i, (r, a) in enumerate(zip(ref_blocks, alt_blocks)):
        ref[i, : len(r)] = r
        alt[i, 1 : 1 + len(a)] = a
        rl[i] = len(r)
        al[i] = len(a)
    tb, final_state = _align_scores(
        *(torch.from_numpy(x).to(dev) for x in (ref, alt, rl, al)), Lr, La
    )
    tb = tb.cpu().numpy()
    final_state = final_state.cpu().numpy()
    out = []
    for n in range(N):
        i, j = int(rl[n]), int(al[n])
        state = int(final_state[n])
        ops = []
        while i > 0 or j > 0:
            byte = tb[n, i, j]
            if state == 0:
                i -= 1
                j -= 1
                ops.append(("M", i, j))
                state = int(byte & 3)
            elif state == 1:
                i -= 1
                ops.append(("D", i, j))
                state = 1 if (byte >> 2) & 1 else 0
            else:
                j -= 1
                ops.append(("I", i, j))
                state = 2 if (byte >> 3) & 1 else 0
        ops.reverse()
        out.append(ops)
    return out
