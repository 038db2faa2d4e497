"""Read iteration of the PyTorch port's readmap (get_prefix_reads,
get_longest_prefix_read, get_reads_containing, find_overlap_reads) against
the JAX package's, on the world of tests/test_sdk_helpers.py: the store and
readmap built by JAX and carried across with convert, the same queries,
whole lists compared.  Tolerance: exact equality."""

import numpy as np
import pytest
import torch

from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu_torch import convert
from biograph_tpu_torch.core import dna


@pytest.fixture(scope="module")
def world():
    """tests/test_sdk_helpers.py's world: 60-base reads every 4 bases of a
    3000-base donor with a SNP at 1500, odd rows reverse-complemented; and
    a second readmap of trimmed reads, so lengths differ."""
    rng = np.random.default_rng(99)
    G = 3000
    flat = rng.integers(0, 4, G).astype(np.uint8)
    donor = flat.copy()
    donor[1500] = (donor[1500] + 1) % 4
    rows = [donor[s : s + 60] for s in range(0, G - 60, 4)]
    codes = np.stack(rows).astype(np.uint8)
    codes[1::2] = (3 - codes[1::2])[:, ::-1]
    lens = np.full(len(rows), 60, np.int32)
    out = {}
    for name, ln in (("uniform", lens), ("trimmed", np.where(np.arange(len(lens)) % 3 == 0, lens - rng.integers(1, 25, len(lens)).astype(np.int32), lens))):
        c = np.where(np.arange(60)[None, :] < ln[:, None], codes, 0).astype(np.uint8)
        js = jax_build_seqset(c, ln)
        jr = jax_build_readmap(js, c, ln)
        arrays = {k: np.asarray(getattr(js, k)) for k in convert.SEQSET_DTYPES}
        arrays.update(n_entries=js.n_entries, max_entry_len=js.max_entry_len)
        ts = convert.seqset_from_numpy(arrays, "cpu")
        tr = convert.readmap_from_numpy({k: np.asarray(getattr(jr, k)) for k in convert.READMAP_DTYPES}, ts, "cpu")
        out[name] = dict(js=js, jr=jr, ts=ts, tr=tr, codes=c, lens=ln)
    return out, donor


class _E:
    def __init__(self, begin, end, size):
        self.begin, self.end, self.size = begin, end, size


def _entries(w, rows, sizes):
    """Seqset ranges of the first `sizes` bases of the given read rows."""
    out = []
    for i, m in zip(rows, sizes):
        b, e, s = w["ts"].find_str(dna.codes_to_seq(w["codes"][i][:m]))
        out.append(_E(b, e, s))
    return out


@pytest.mark.parametrize("name", ["uniform", "trimmed"])
def test_prefix_reads(world, name):
    w = world[0][name]
    rows = [0, 1, 361]
    entries = _entries(w, rows, [int(w["lens"][i]) for i in rows]) + _entries(w, [9], [20])
    entries.append(_E(0, w["ts"].n_entries, 0))  # the empty sequence
    for i, e in enumerate(entries):
        min_len = 50 if i == 1 else 0
        assert w["tr"].get_prefix_reads(e, min_len) == w["jr"].get_prefix_reads(e, min_len)
    assert w["tr"].get_longest_prefix_read(entries[0]) == w["jr"].get_longest_prefix_read(entries[0])
    whole = w["tr"].get_prefix_reads(entries[0])
    assert any(length == int(w["lens"][0]) for _, length in whole)
    assert [m for _, m in whole] == sorted((m for _, m in whole), reverse=True)


@pytest.mark.parametrize("name", ["uniform", "trimmed"])
def test_reads_containing(world, name):
    w = world[0][name]
    donor = world[1]
    rng = np.random.default_rng(5)
    queries = [w["codes"][10][20:45], w["codes"][11][5:35], donor[1490:1515], rng.integers(0, 4, 25).astype(np.uint8)]
    for q in queries:
        for max_levels in (None, 4):
            got = w["tr"].get_reads_containing(q, max_levels)
            assert got == w["jr"].get_reads_containing(q, max_levels)
    assert w["tr"].get_reads_containing(dna.codes_to_seq(queries[0])) == w["jr"].get_reads_containing(queries[0])
    assert 10 in {rid for rid, _ in w["tr"].get_reads_containing(queries[0])}
    assert w["tr"].get_reads_containing(queries[3]) == []


@pytest.mark.parametrize("name", ["uniform", "trimmed"])
def test_overlap_reads(world, name):
    w = world[0][name]
    donor = world[1]
    for lo, hi, min_ov in ((1000, 1080, 45), (1480, 1560, 50), (200, 230, 25)):
        win = donor[lo:hi]
        got = w["tr"].find_overlap_reads(win, min_overlap=min_ov)
        assert got == w["jr"].find_overlap_reads(win, min_overlap=min_ov)
        assert all(ov >= min_ov for _, ov in got)
    got = w["tr"].find_overlap_reads(torch.from_numpy(donor[1000:1080].copy()), min_overlap=30)
    assert got and got[0][1] >= 55 and all(ov >= 30 for _, ov in got)
    assert w["tr"].find_overlap_reads(donor[:10], min_overlap=20) == []
