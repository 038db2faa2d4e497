"""Readmap: seqset entries <-> reads, lengths, pairing (torch).

Counterpart of ``biograph_tpu/index/readmap.py``:
  * CSR ``offsets`` mapping seqset entry -> readmap entries
  * per readmap entry: read length, is_forward bit, mate-loop link
    (fwd -> RC -> mate -> mate-RC cycle)

A "readmap entry" exists for each orientation of each read (a read and its
reverse complement are separate entries pointing at different seqset
entries, linked by the mate loop).  read_count == num_entries / 2.

All queries are batched tensors in, tensors out.  Coverage
(``coverage``, ``coverage_events``) runs the JAX package's three probe
routes in its order, on the readmap's device:

  * uniform reads with a window hash (every read as long as the longest
    entry): one rolling-hash lookup a position, no rank at all;
  * uniform reads without one: the ``chain_fixed`` entry of the
    ``chain_window`` kernel, ``max_entry_len`` steps a lane;
  * mixed read lengths: the restart chain ``probes.probe_ranges`` (the
    ``rank`` kernel each step), then ``find_window_auto`` and
    ``probe_exact_kernel`` (``chain_window``) over the restarted lanes.

Read iteration (``get_prefix_reads``, ``get_longest_prefix_read``,
``get_reads_containing``, ``find_overlap_reads``) returns the JAX package's
Python lists in its order.  Where the JAX package runs one seqset query a
length, the port runs one batch with a lane a length (``truncate_ranges``
for the prefix reads, ``find`` for the overlaps), and the frontier of
``get_reads_containing`` advances one level a ``push4`` launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import warnings

import numpy as np
import torch

from biograph_tpu_torch import resolve_device
from biograph_tpu_torch.core import container, dna
from biograph_tpu_torch.index import probes
from biograph_tpu_torch.ops import rank4 as rank4_ops

_TENSOR_FIELDS = ("offsets", "read_lengths", "is_forward", "mate_pair_ptr", "read_ids")
ENTRY_CHUNK = 1 << 17  # full-length entries hashed a chunk
SLAB_LANES = 1 << 20  # (row, position) lanes a coverage slab, at most


@dataclass
class Readmap:
    seqset: object
    # CSR over seqset entries -> readmap entry ids
    offsets: torch.Tensor  # int64 [n_seqset_entries + 1]
    read_lengths: torch.Tensor  # int32 [n_rm]
    is_forward: torch.Tensor  # bool [n_rm]
    mate_pair_ptr: torch.Tensor  # int64 [n_rm] — next link in the mate loop
    read_ids: torch.Tensor  # int64 [n_rm] — original read index
    uuid: str = ""
    coverage_truncated: int = 0  # reads dropped by the kmax per-entry cap
    _warned_truncation: bool = False

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    @property
    def num_entries(self) -> int:
        return self.read_lengths.shape[0]

    @property
    def read_count(self) -> int:
        return self.num_entries // 2

    @cached_property
    def entry_of_rm(self) -> torch.Tensor:
        """seqset entry id owning each readmap entry (reverse CSR)."""
        n = self.offsets.shape[0] - 1
        counts = self.offsets[1:] - self.offsets[:-1]
        ids = torch.arange(n, dtype=torch.int64, device=self.device)
        return torch.repeat_interleave(ids, counts)

    @cached_property
    def length_groups(self):
        """Per-entry attached-read counts grouped by (read length, strand).

        Returns (lens int32 [D], counts int32 [D, 2, n_entries]) where
        counts[d, 0] counts attached reads of length lens[d] whose
        is_forward is False and counts[d, 1] those with True."""
        n = self.offsets.shape[0] - 1
        ent = self.entry_of_rm
        lens = torch.unique(self.read_lengths)
        counts = torch.zeros((len(lens), 2, n), dtype=torch.int32, device=self.device)
        fwd = self.is_forward
        for d, m in enumerate(lens):
            sel = self.read_lengths == m
            counts[d, 0] = torch.bincount(ent[sel & ~fwd], minlength=n)
            counts[d, 1] = torch.bincount(ent[sel & fwd], minlength=n)
        return lens.to(torch.int32), counts

    @cached_property
    def window_hash(self):
        """Hash index of full-length entries for the uniform coverage probe:
        with every read as long as the longest entry, a full-depth window of
        the coverage walk can only be a whole entry, so the probe's answer is
        the range [entry, entry + 1) found by one hash lookup.  Returns
        (keys int64 [n] sorted, ids int64 [n], depth) or None.

        A key is ``(h1 << 32) | h2`` with the bits of the JAX package's
        (``_entry_keys``); the keys are built chunk by chunk for the
        full-length entries only, from the packed entry words the build kept
        or else from ``Seqset.d.sequences``, never from an [n, depth]
        matrix of every entry."""
        ss = self.seqset
        depth = int(ss.max_entry_len)
        if depth < 8 or self.num_entries == 0:
            return None
        full = torch.nonzero(ss.entry_sizes >= depth)[:, 0]
        if full.shape[0] == 0:
            return None
        cached = ss.__dict__.get("_entry_cache")
        keys = []
        for lo in range(0, full.shape[0], ENTRY_CHUNK):
            ids = full[lo : lo + ENTRY_CHUNK]
            if cached is not None:
                seqs = dna.unpack_words(cached[0][ids.to(cached[0].device)], depth)
            else:
                seqs = ss.d.sequences(ids, depth)
            keys.append(_entry_keys(seqs.to(self.device), depth))
        key = torch.cat(keys)
        order = torch.sort(key, stable=True)
        return order.values, full[order.indices], depth

    @cached_property
    def min_read_len(self) -> int:
        if self.num_entries == 0:
            return 0
        return int(self.read_lengths.min())

    @cached_property
    def max_read_len(self) -> int:
        if self.num_entries == 0:
            return 0
        return int(self.read_lengths.max())

    # ------------- batched queries -------------

    def _ids(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(torch.int64)

    def entry_read_range(self, entries):
        """[start, end) into readmap-entry ids for each seqset entry."""
        e = self._ids(entries)
        return self.offsets[e], self.offsets[e + 1]

    def entry_read_count(self, entries):
        s, e = self.entry_read_range(entries)
        return e - s

    def get_rev_comp(self, rm_ids):
        """Mate loop walked 1 (forward) or 3 (rc) times."""
        rm_ids = self._ids(rm_ids)
        loop = self.mate_pair_ptr
        one = loop[rm_ids]
        three = loop[loop[one]]
        return torch.where(self.is_forward[rm_ids], one, three)

    def get_mate(self, rm_ids):
        """Mate = loop twice; for unpaired returns self."""
        loop = self.mate_pair_ptr
        return loop[loop[self._ids(rm_ids)]]

    def has_mate(self, rm_ids):
        return self.get_mate(rm_ids) != self._ids(rm_ids)

    def get_pair_stats(self):
        loop = self.mate_pair_ptr
        mate2 = loop[loop]
        paired = mate2 != torch.arange(self.num_entries, device=self.device)
        fwd = self.is_forward
        lens = self.read_lengths.to(torch.int64)
        return {
            "paired_reads": int((paired & fwd).sum()),
            "paired_bases": int(lens[paired & fwd].sum()),
            "unpaired_reads": int((~paired & fwd).sum()),
            "unpaired_bases": int(lens[~paired & fwd].sum()),
        }

    # ------------- read iteration (SDK surface) -------------

    def _attached(self, begin, end):
        """Every readmap entry attached to each range [begin, end): (lane,
        readmap-entry id) int64 tensors, lane by lane, each lane's in
        readmap order."""
        lo = self.offsets[begin]
        cnt = (self.offsets[end] - lo).clamp(min=0)
        lane = torch.repeat_interleave(torch.arange(cnt.shape[0], device=self.device), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        idx = lo[lane] + torch.arange(lane.shape[0], device=self.device) - first[lane]
        return lane, idx

    @staticmethod
    def _seq_codes(seq) -> np.ndarray:
        if isinstance(seq, str):
            return dna.seq_to_codes(seq)
        if isinstance(seq, torch.Tensor):
            seq = seq.cpu().numpy()
        return np.asarray(seq, np.uint8)

    def get_prefix_reads(self, entry, min_read_len: int = 0):
        """Reads that are a PREFIX of the range's sequence: for every
        truncation length m, reads of length exactly m attached to the
        widened range.  Returns [(read_id, length)] descending by length.
        ``entry`` is a SeqsetEntry-like (begin, end, size)."""
        from biograph_tpu_torch.index.seqset import SeqsetRanges

        size = int(entry.size)
        lengths = range(size, max(min_read_len, self.min_read_len) - 1, -1)
        M = len(lengths)
        if M == 0:
            return []
        ms = torch.tensor(lengths, dtype=torch.int32, device=self.device)
        r = SeqsetRanges(
            torch.full((M,), int(entry.begin), dtype=torch.int64, device=self.device),
            torch.full((M,), int(entry.end), dtype=torch.int64, device=self.device),
            torch.full((M,), size, dtype=torch.int32, device=self.device),
        )
        t = self.seqset.d.truncate_ranges(r, ms)
        lane, idx = self._attached(t.begin, t.end)
        keep = self.read_lengths[idx] == ms[lane]
        return list(zip(self.read_ids[idx[keep]].tolist(), ms[lane[keep]].tolist()))

    def get_longest_prefix_read(self, entry):
        reads = self.get_prefix_reads(entry)
        return reads[0] if reads else None

    def get_reads_containing(self, seq, max_levels: int | None = None):
        """Reads containing ``seq`` anywhere: a breadth-first leftward
        extension whose frontier (seq with o prepended bases) advances one
        level a ``push4`` over every frontier lane; reads attached to a
        frontier range with read_len >= the range's size contain seq at
        offset o.  Returns [(read_id, offset)] sorted by (offset, read_id),
        each pair once."""
        d = self.seqset.d
        codes = self._seq_codes(seq)
        L = len(codes)
        r = d.find(
            torch.from_numpy(codes[None, :].copy()).to(self.device),
            torch.tensor([L], dtype=torch.int32, device=self.device),
        )
        if not bool(r.begin[0] < r.end[0]):
            return []
        out = set()
        max_levels = self.max_read_len - L if max_levels is None else max_levels
        for level in range(max_levels + 1):
            lane, idx = self._attached(r.begin, r.end)
            keep = self.read_lengths[idx] >= r.size[lane]
            out.update((rid, level) for rid in self.read_ids[idx[keep]].tolist())
            if level == max_levels or r.begin.shape[0] == 0:
                break
            nb4, ne4 = d.push4(r)
            nb, ne = nb4.reshape(-1), ne4.reshape(-1)
            live = nb < ne
            r = type(r)(nb[live], ne[live], torch.repeat_interleave(r.size + 1, 4)[live])
        return sorted(out, key=lambda t: (t[1], t[0]))

    def find_overlap_reads(self, seq, min_overlap: int = 20):
        """Reads whose PREFIX matches a SUFFIX of ``seq`` with overlap >=
        min_overlap (the assembly extension query).  Returns [(read_id,
        overlap)] descending by overlap, each read once, at its longest."""
        codes = self._seq_codes(seq)
        L = len(codes)
        ms = list(range(min(L, self.max_read_len), min_overlap - 1, -1))
        if not ms:
            return []
        # one find a suffix length, all in one batch (shorter suffixes padded)
        width = max(ms)
        suf = np.zeros((len(ms), width), np.uint8)
        for i, m in enumerate(ms):
            suf[i, :m] = codes[L - m :]
        m_t = torch.tensor(ms, dtype=torch.int32, device=self.device)
        r = self.seqset.d.find(torch.from_numpy(suf).to(self.device), m_t)
        lane, idx = self._attached(r.begin, r.end)
        keep = self.read_lengths[idx] >= m_t[lane]
        out, seen = [], set()
        for rid, i in zip(self.read_ids[idx[keep]].tolist(), lane[keep].tolist()):
            if rid not in seen:
                seen.add(rid)
                out.append((rid, ms[i]))
        return out

    # ------------- coverage (sequence-level queries) -------------

    def coverage(self, codes, lengths, kmax: int = 16):
        """Per-base read coverage of query sequences, split by strand.

        Walks the complement of each query; wherever the probe range is
        unique, reads attached to its entry with read_len <= range size end
        at that position (strand flipped: the walk builds the complement).

        codes: [B, L] uint8 (numpy or tensor); lengths: [B]; kmax bounds the
        reads gathered an entry where reads of more than eight lengths make
        per-entry totals unavailable (beyond it reads are counted in
        ``coverage_truncated``, with one warning).

        Returns (fwd_cov, rev_cov): int32 [B, L] on the readmap's device."""
        fwd, rev, _, _ = self._coverage_full(codes, lengths, kmax)
        return fwd, rev

    def coverage_events(self, codes, lengths, kmax: int = 16):
        """Raw read start/end events under each query window: (starts,
        ends), int32 [B, L] counts of reads (both strands summed) starting /
        ending at each position whose full body matches the window there."""
        _, _, starts, ends = self._coverage_full(codes, lengths, kmax)
        return starts, ends

    def _coverage_full(self, codes, lengths, kmax: int = 16, use_hash: bool = True):
        if isinstance(codes, torch.Tensor):
            codes = codes.cpu().numpy()
        if isinstance(lengths, torch.Tensor):
            lengths = lengths.cpu().numpy()
        codes = np.asarray(codes, np.uint8)
        lengths = np.asarray(lengths, np.int32)
        B, L = codes.shape
        # shape buckets: L -> multiple of 64, B -> power of two
        Lp = max(64, -(-L // 64) * 64)
        Bp = 1
        while Bp < B:
            Bp *= 2
        cp = np.zeros((Bp, Lp), np.uint8)
        cp[:B, :L] = codes
        lp = np.zeros(Bp, np.int32)
        lp[:B] = lengths
        fwd, rev, starts, ends, nt = self._coverage_probe(cp, lp, kmax, use_hash)
        self.coverage_truncated += nt
        if nt and not self._warned_truncation:
            self._warned_truncation = True
            warnings.warn(
                f"readmap.coverage: {nt} reads beyond the kmax={kmax} "
                "per-entry cap were not counted (duplicate-heavy entries); "
                "raise kmax for exact depth"
            )
        return fwd[:B, :L], rev[:B, :L], starts[:B, :L], ends[:B, :L]

    def _coverage_probe(self, cp, lp, kmax: int, use_hash: bool = True):
        """The coverage walk as per-position probes: the walk state at query
        position j is the longest existing window ending at j, computed for
        every (row, position) lane of a slab at once, then one counting pass.

        With min_read_len == max_read_len == max_entry_len only windows of
        exactly that length can count, so one fixed-depth probe a lane
        replaces the restart chain and the exact recompute: by hash, or (no
        hash, or ``use_hash`` False) by ``chain_fixed``."""
        ss = self.seqset
        d = ss.d
        dev = self.device
        Bp, Lp = cp.shape
        depth = min(max(int(ss.max_entry_len), 1), Lp)
        uniform = self.num_entries > 0 and self.min_read_len == self.max_read_len == depth
        min_rl = max(min(self.min_read_len, depth), 1)
        text = torch.from_numpy(cp.reshape(-1)).to(dev)
        # slabs of pow2 rows keep the lane tensors at most SLAB_LANES long
        rows = max(min(SLAB_LANES // Lp, Bp), 1)
        rows = 1 << (rows.bit_length() - 1)
        lens, grp = self.length_groups
        outs = []
        for r0 in range(0, Bp, rows):
            P = rows * Lp
            pos = torch.arange(P, dtype=torch.int64, device=dev) + r0 * Lp
            slab = text[r0 * Lp : r0 * Lp + P]
            wh = self.window_hash if (uniform and use_hash) else None
            if wh is not None:
                keys, ids, _ = wh
                b, e, s = _uniform_hash_probe(keys, ids, slab, *_hash_pows(P, dev), Lp, depth)
            elif uniform:
                b, e, s = rank4_ops.chain_fixed(
                    d.rank_blocks, d.entry_sizes, d.fixed, slab, depth
                )
                b, e, s = _row_mask(b, e, s, pos, Lp, depth)
            else:
                b, e, s = self._general_probe(d, text, r0, P, Lp, depth, min_rl, lp)
            lp_slab = torch.from_numpy(lp[r0 : r0 + rows]).to(dev)
            if 0 < lens.shape[0] <= 8:
                # per-entry (length, strand) totals: exact depth in D passes,
                # no kmax cap at any duplication level
                outs.append(
                    _coverage_count_grouped(d, lens, grp, b, e, s, lp_slab, rows, Lp, min_rl) + (0,)
                )
            else:
                outs.append(
                    _coverage_count(
                        d, self.offsets, self.read_lengths, self.is_forward,
                        b, e, s, lp_slab, rows, Lp, kmax, min_rl,
                    )
                )
        fwd, rev, starts, ends = (torch.cat([o[i] for o in outs]) for i in range(4))
        return fwd, rev, starts, ends, sum(int(o[4]) for o in outs)

    def _general_probe(self, d, text, r0: int, P: int, Lp: int, depth: int, min_rl: int, lp):
        """Mixed read lengths: the restart chain over the slab, then the exact
        longest window of the restarted lanes that can hold a read (a
        min_rl find-window filter, then the bisection from it)."""
        dev = self.device
        pos = torch.arange(P, dtype=torch.int64, device=dev) + r0 * Lp
        b, e, s, restarted = probes.probe_ranges(d, text, r0 * Lp, pos // Lp * Lp, P, depth)
        # padding lanes (beyond each row's length) restart on garbage, and a
        # lane whose window cannot reach min_read_len never counts a read
        li = np.arange(P)
        rst = probes.fetch_mask(restarted) & ((li % Lp) < lp[r0 + li // Lp])
        rst &= (li % Lp) + 1 >= min_rl
        if not rst.any():
            return b, e, s
        idx_p = torch.from_numpy(np.nonzero(rst)[0]).to(dev)
        pos_p = idx_p + r0 * Lp
        fb, fe, fs = probes.find_window_auto(d, text, pos_p, min_rl, depth)
        alive = probes.fetch_mask(fb < fe)
        if not alive.any():
            return b, e, s
        sel = torch.from_numpy(np.nonzero(alive)[0]).to(dev)
        pos2 = pos_p[sel]
        b2, e2, s2 = probes.probe_exact_kernel(
            d, text, pos2, pos2 // Lp * Lp, depth, min_rl, (fb[sel], fe[sel], fs[sel])
        )
        di = idx_p[sel]
        b, e, s = b.clone(), e.clone(), s.clone()
        b[di], e[di], s[di] = b2, e2, s2
        return b, e, s

    def to(self, device="cuda") -> "Readmap":
        """This readmap with every tensor on ``device``, over its seqset
        moved there too (``Seqset.to``)."""
        dev = resolve_device(device)
        ss = self.seqset
        if ss.device != dev:
            ss = ss.to(dev)
        return Readmap(
            seqset=ss,
            **{name: getattr(self, name).to(dev) for name in _TENSOR_FIELDS},
            uuid=self.uuid,
        )

    # ------------- persistence -------------

    def save(self, path: str):
        def host(t, dtype):
            return t.cpu().numpy().astype(dtype, copy=False)

        with container.ArtifactWriter(path, "readmap") as w:
            w.set_scalar("seqset_uuid", getattr(self.seqset, "uuid", ""))
            w.add_array("offsets", host(self.offsets, np.int64))
            w.add_array("read_lengths", host(self.read_lengths, np.int32))
            w.add_array("is_forward", host(self.is_forward, bool))
            w.add_array("mate_pair_ptr", host(self.mate_pair_ptr, np.int64))
            w.add_array("read_ids", host(self.read_ids, np.int64))
            self.uuid = w.meta["uuid"]

    @staticmethod
    def load(path: str, seqset, device="cuda") -> "Readmap":
        from biograph_tpu_torch.convert import READMAP_DTYPES, readmap_from_numpy

        dev = resolve_device(device)
        r = container.ArtifactReader(path, "readmap", mmap=False)
        rm = readmap_from_numpy(
            {name: r.array(name) for name in READMAP_DTYPES}, seqset, dev
        )
        rm.uuid = r.uuid
        return rm


# ---------------------------------------------------------------------------
# the probes of the coverage walk
# ---------------------------------------------------------------------------

# rolling-hash constants of the uniform coverage probe (any odd multipliers)
_HM1, _HM2 = 0x9E3779B1, 0x85EBCA77
MASK32 = 0xFFFFFFFF


def _hash_pows(P: int, dev):
    """(m1^t, m1^-t, m2^t, m2^-t) mod 2^32 for t in [0, P), int64 on dev:
    a running product wraps mod 2^64, which keeps its low 32 bits exact."""

    def pows(m):
        f = torch.full((P,), m, dtype=torch.int64, device=dev)
        f[0] = 1
        return torch.cumprod(f, 0) & MASK32

    return (
        pows(_HM1),
        pows(pow(_HM1, -1, 1 << 32)),
        pows(_HM2),
        pows(pow(_HM2, -1, 1 << 32)),
    )


def _key64(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """The int64 whose bits are ``(h1 << 32) | h2`` for 32-bit h1, h2 held
    in int64: h1 re-read as a signed 32-bit value times 2^32 cannot
    overflow, and its low 32 bits are zero, so adding h2 sets them."""
    return dna.u32_to_i32(h1).to(torch.int64) * (1 << 32) + h2


def _entry_keys(seqs: torch.Tensor, depth: int) -> torch.Tensor:
    """Hash keys of entry sequences, uint8 [c, depth]: h = sum_i (base_i + 1)
    * m^i mod 2^32 for both multipliers."""
    s = seqs[:, :depth].to(torch.int64) + 1
    pw1, _, pw2, _ = _hash_pows(depth, seqs.device)
    h1 = (s * pw1[None, :]).sum(dim=1) & MASK32
    h2 = (s * pw2[None, :]).sum(dim=1) & MASK32
    return _key64(h1, h2)


def _uniform_hash_probe(keys, ids, text, pw1, pwinv1, pw2, pwinv2, Lp: int, depth: int):
    """(begin, end, size) of the full-depth window ending at every position,
    by rolling hash and binary search.

    The window the walk builds at j is revcomp(text[j-depth+1..j]), so
    H(j) = sum_i (comp(text[j-i]) + 1) * m^i = m^j * (P(j) - P(j-depth))
    with P the prefix sum of (comp(text[t]) + 1) * m^-t, all mod 2^32.  The
    prefix sum of values below 2^34 over at most 2^20 positions stays below
    2^54, so it is masked after the sum; int64 products wrap, so their low 32
    bits are exact.  A window must lie inside its row: (pos % Lp) + 1 >=
    depth."""
    P = text.shape[0]
    dev = text.device
    cc = (3 - text.to(torch.int64)) + 1
    pos = torch.arange(P, dtype=torch.int64, device=dev)

    def roll(pw, pwinv):
        pref = torch.cumsum(cc * pwinv, 0)
        shifted = torch.cat([pref.new_zeros(depth), pref[:-depth]])
        return (((pref - shifted) & MASK32) * pw) & MASK32

    key = _key64(roll(pw1, pwinv1), roll(pw2, pwinv2))
    idx = torch.searchsorted(keys, key)
    idxc = idx.clamp(0, keys.shape[0] - 1)
    hit = (keys[idxc] == key) & ((pos % Lp) + 1 >= depth)
    b = torch.where(hit, ids[idxc], 0)
    e = torch.where(hit, b + 1, b)
    s = torch.where(hit, depth, 0).to(torch.int32)
    return b, e, s


def _row_mask(b, e, s, pos, Lp: int, depth: int):
    """Invalidate windows that would cross a row boundary (j < depth-1)."""
    ok = (pos % Lp) + 1 >= depth
    return b, torch.where(ok, e, b), s


def _count_runs(starts, ends, L: int):
    """Per-strand coverage from start/end events: a read covers a position
    from its start up to its end."""
    covs = []
    for s_i in range(2):
        padded = torch.nn.functional.pad(ends[s_i], (1, 0))[:, :L]
        run = torch.cumsum(starts[s_i], dim=1) - torch.cumsum(padded, dim=1)
        covs.append(run.to(torch.int32))
    return covs[0], covs[1], starts.sum(dim=0).to(torch.int32), ends.sum(dim=0).to(torch.int32)


def _coverage_count_grouped(d, lens, grp, begin, end, size, lengths, B: int, L: int, min_rl: int = 1):
    """Exact read counting from per-entry (length, strand) totals
    (``Readmap.length_groups``): D passes, no kmax cap.  lens int32 [D];
    grp int32 [D, 2, n_entries].  A masked lane adds 0 at a clipped index,
    so every pass scatters B*L values."""
    dev = begin.device
    n_entries = d.n_entries
    begin = begin.reshape(B, L)
    end = end.reshape(B, L)
    size = size.reshape(B, L)
    j = torch.arange(L, device=dev)[None, :]
    active = j < lengths[:, None]
    unique = active & (begin + 1 == end) & (size >= min_rl)
    e = begin.clamp(0, n_entries - 1)
    starts = torch.zeros((2, B, L), dtype=torch.int32, device=dev)
    ends = torch.zeros((2, B, L), dtype=torch.int32, device=dev)
    b2 = torch.arange(B, device=dev)[:, None].expand(B, L)
    for di in range(lens.shape[0]):  # D is tiny (1 for uniform libraries)
        m = lens[di].to(torch.int64)
        start_pos = j + 1 - m
        match = unique & (m <= size) & (start_pos >= 0)
        sp = start_pos.clamp(0, L - 1).expand(B, L)
        for s_i in range(2):
            cnt = torch.where(match, grp[di, s_i][e], 0).to(torch.int32)
            starts[s_i].index_put_((b2, sp), cnt, accumulate=True)
            ends[s_i] += cnt
    return _count_runs(starts, ends, L)


def _coverage_count(d, offsets, rlen, isfwd, begin, end, size, lengths, B: int, L: int, kmax: int, min_rl: int = 1):
    """Read counting over per-position probe ranges, up to kmax reads an
    entry: wherever a position's range is unique, reads attached to its
    entry with read_len <= context end there (strand flipped).  Returns the
    four event/coverage tensors and the count of reads past the cap."""
    dev = begin.device
    n_entries = d.n_entries
    n_rm = max(int(rlen.shape[0]), 1)
    begin = begin.reshape(B, L)
    end = end.reshape(B, L)
    size = size.reshape(B, L)
    j = torch.arange(L, device=dev)[None, :]
    active = j < lengths[:, None]
    # a window shorter than the shortest read can never host a read end
    unique = active & (begin + 1 == end) & (size >= min_rl)
    e = begin.clamp(0, n_entries - 1)
    rs = offsets[e]
    re = offsets[e + 1]
    n_trunc = torch.where(unique, (re - rs - kmax).clamp(min=0), 0).sum()
    ridx = rs[:, :, None] + torch.arange(kmax, device=dev)  # [B, L, K]
    ok = unique[:, :, None] & (ridx < re[:, :, None])
    ric = ridx.clamp(0, n_rm - 1)
    if rlen.shape[0]:
        m = rlen[ric].to(torch.int64)
        strand_rev = isfwd[ric]  # the complement walk flips strand
    else:
        m = torch.zeros_like(ric)
        strand_rev = torch.zeros_like(ok)
    start_pos = j[:, :, None] + 1 - m
    match = ok & (m <= size[:, :, None]) & (start_pos >= 0)
    hit_f = (match & ~strand_rev).to(torch.int32)
    hit_r = (match & strand_rev).to(torch.int32)
    sp = start_pos.clamp(0, L - 1)
    b3 = torch.arange(B, device=dev)[:, None, None].expand(sp.shape)
    starts = torch.zeros((2, B, L), dtype=torch.int32, device=dev)
    starts[0].index_put_((b3, sp), hit_f, accumulate=True)
    starts[1].index_put_((b3, sp), hit_r, accumulate=True)
    ends = torch.stack([hit_f.sum(dim=2), hit_r.sum(dim=2)]).to(torch.int32)
    return _count_runs(starts, ends, L) + (n_trunc,)
