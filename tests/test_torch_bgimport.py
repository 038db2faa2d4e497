"""The reference's ``.bg`` archives through the port's importer
(``io/bgimport.py``) against the JAX package's, exact equality.  A store
and readmap built by the JAX package are written as a ``.bg`` dir by the
fixture writer of ``chip_smoke.py``, in the v1.0 form (uint8 membufs, a
32-bit and a 1-bit ``packed_vector``) and in the v1.1 form
(``packed_varbit`` of widths 7, 13, 33 and 61, so fields cross 64-bit
words); both importers give every field equal, and equal to the original
store (the readmap's read ids excepted: a .bg readmap has none, entry i is
read i); ``BioGraph(.bg, device="cpu")`` answers as the JAX ``BioGraph``
does; the import runs ``rank_cum``'s plain version on the CPU, once for the
four bases; a wrong bit count raises in both packages."""

import os

import numpy as np
import pytest
import torch

from biograph_tpu.api import BioGraph as JBioGraph
from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu.io import bgimport as jbg
from biograph_tpu_torch.api import BioGraph
from biograph_tpu_torch.core import dna
from biograph_tpu_torch.io import bgimport as tbg
from biograph_tpu_torch.ops import rank_cum as rank_cum_ops
from test_torch_cli import _chip_smoke as _cs

SEQSET_FIELDS = ("fixed", "prev_words", "prev_cum", "entry_sizes", "shared", "pop_sel")
READMAP_FIELDS = ("offsets", "read_lengths", "is_forward", "mate_pair_ptr")
V11 = {"entry_sizes": 7, "shared": 13, "read_lengths": 33, "mate_loop_ptr": 61}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A JAX-built store of 500 pairs of 40-100 bases over a 5000-base
    genome, its numpy fields, and .bg dirs of it in both forms."""
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, 5000, dtype=np.uint8)
    n = 1000
    lens = rng.integers(40, 101, n).astype(np.int32)
    starts = rng.integers(0, 5000 - 100, n)
    codes = np.zeros((n, 100), np.uint8)
    for i in range(n):
        read = genome[starts[i] : starts[i] + lens[i]]
        codes[i, : lens[i]] = read if i % 2 == 0 else (3 - read)[::-1]
    mate_of = np.arange(n) ^ 1
    js = jax_build_seqset(codes, lens)
    jrm = jax_build_readmap(js, codes, lens, mate_of)
    ss = {f: np.asarray(getattr(js, f)) for f in SEQSET_FIELDS}
    ss.update(n_entries=int(js.n_entries), max_entry_len=int(js.max_entry_len))
    rm = {f: np.asarray(getattr(jrm, f)) for f in (*READMAP_FIELDS, "read_ids")}
    root = tmp_path_factory.mktemp("bg")
    dirs = {form: _cs().write_bg_dir(str(root / f"{form}.bg"), ss, rm, bits=bits) for form, bits in (("v1.0", None), ("v1.1", V11))}
    return dict(ss=ss, rm=rm, dirs=dirs, codes=codes, lens=lens, genome=genome)


@pytest.mark.parametrize("form", ["v1.0", "v1.1"])
def test_import_equal_to_jax_and_to_the_store(store, form):
    path = store["dirs"][form]
    ss, rm, meta = tbg.open_bg_dir(path, device="cpu")
    jss, jrm, jmeta = jbg.open_bg_dir(path)
    assert meta == jmeta == {"accession_id": f"{form}.bg"}
    assert ss.n_entries == jss.n_entries == store["ss"]["n_entries"]
    assert ss.max_entry_len == jss.max_entry_len == store["ss"]["max_entry_len"]
    for f in SEQSET_FIELDS:
        got = getattr(ss, f).numpy()
        if f == "prev_words":
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, np.asarray(getattr(jss, f)), err_msg=f)
        np.testing.assert_array_equal(got, store["ss"][f], err_msg=f)
        assert getattr(ss, f).device.type == "cpu"
    for f in READMAP_FIELDS:
        got = getattr(rm, f).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(jrm, f)), err_msg=f)
        np.testing.assert_array_equal(got, store["rm"][f], err_msg=f)
    np.testing.assert_array_equal(rm.read_ids.numpy(), np.asarray(jrm.read_ids))
    np.testing.assert_array_equal(rm.read_ids.numpy(), np.arange(rm.num_entries))
    assert rm.read_count == jrm.read_count == 1000


def test_decode_varbit_widths_equal_to_jax():
    """Every width from 1 to 64 over values that fill it, so fields start at
    every shift and cross 64-bit words."""
    rng = np.random.default_rng(4)
    for bits in range(1, 65):
        vals = rng.integers(0, 1 << min(bits, 62), 301, dtype=np.int64)
        if bits == 64:
            vals[:3] = [-1, np.iinfo(np.int64).min, np.iinfo(np.int64).max]
        data = _cs().pack_varbit(vals.astype(np.uint64), bits)
        meta = {"element_count": len(vals), "bits_per_value": bits}
        got = tbg.decode_varbit(data, meta)
        np.testing.assert_array_equal(got, jbg.decode_varbit(data, meta))
        np.testing.assert_array_equal(got, vals, err_msg=f"bits {bits}")
    assert len(tbg.decode_varbit(b"", {"element_count": 0, "bits_per_value": 7})) == 0
    np.testing.assert_array_equal(tbg.decode_varbit(b"", {"element_count": 4, "bits_per_value": 0}), np.zeros(4))


def test_biograph_on_a_bg_dir_equal_to_jax(store):
    path = store["dirs"]["v1.1"]
    bg, jbgr = BioGraph(path, device="cpu"), JBioGraph(path)
    assert bg.metadata == jbgr.metadata and bg.num_reads == jbgr.num_reads == 1000
    codes, lens = store["codes"], store["lens"]
    for i in (0, 1, 17, 998):
        read = dna.codes_to_seq(codes[i, : lens[i]])
        e, je = bg.find(read), jbgr.find(read)
        assert e.valid and (e.begin, e.end, e.size) == (je.begin, je.end, je.size)
        p, jp = e.pop_front(), je.pop_front()
        assert (p.begin, p.end, p.size) == (jp.begin, jp.end, jp.size)
    for rm_id in (0, 5, 1999):
        r, jr = bg.read(rm_id), jbgr.read(rm_id)
        assert (r.length, r.is_forward, r.read_id, r.entry_id) == (jr.length, jr.is_forward, jr.read_id, jr.entry_id)
        assert str(r.sequence()) == str(jr.sequence())
        assert (r.mate().rm_id if r.mate() else None) == (jr.mate().rm_id if jr.mate() else None)
    window = dna.codes_to_seq(store["genome"][1000:1100])
    np.testing.assert_array_equal(bg.seq_coverage(window), np.asarray(jbgr.seq_coverage(window)))
    assert bg.pair_stats() == jbgr.pair_stats()
    assert bg.find("ACGT" * 40).valid == jbgr.find("ACGT" * 40).valid


def test_import_runs_rank_cum_once_on_the_cpu(store, monkeypatch):
    calls = []

    def counting(words):
        calls.append(words)
        return rank_cum_ops.rank_cum(words)

    monkeypatch.setattr(tbg, "rank_cum", counting)
    before = rank_cum_ops.rank_cum.launches
    ss = tbg.import_bg_seqset(os.path.join(store["dirs"]["v1.0"], "seqset"), device="cpu")
    assert len(calls) == 1 and calls[0].shape == (4, ss.n_entries // 32 + 1)
    assert calls[0].device.type == "cpu" and calls[0].dtype == torch.int32
    assert rank_cum_ops.rank_cum.launches == before  # a CPU tensor takes the plain version, no kernel
    np.testing.assert_array_equal(ss.prev_cum.numpy(), rank_cum_ops.rank_cum_plain(calls[0]).to(torch.int64).numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tbg.open_bg_dir(store["dirs"]["v1.0"])


def test_a_wrong_bit_count_raises_in_both(store, tmp_path):
    """One bit of prev_C flipped: the base's bits no longer fill its block."""
    ss = dict(store["ss"])
    words = ss["prev_words"].copy()
    ones = np.nonzero(np.unpackbits(words[1].view(np.uint8), bitorder="little")[: ss["n_entries"]] == 0)[0]
    words[1, ones[0] // 32] |= np.uint32(1 << (ones[0] % 32))
    ss["prev_words"] = words
    path = _cs().write_bg_dir(str(tmp_path / "bad.bg"), ss, None)
    for importer in (lambda p: tbg.import_bg_seqset(p, device="cpu"), jbg.import_bg_seqset):
        with pytest.raises(ValueError, match="prev_C has .* bits for block"):
            importer(os.path.join(path, "seqset"))


def test_members_of_a_stored_zip():
    """SpiralZip reads the stored members by their local headers and
    refuses a compressed one."""
    data = _cs().stored_zip([("a", b"xyz"), ("b/c.json", b'{"k": 1}')])
    z = tbg.SpiralZip.__new__(tbg.SpiralZip)
    z.path, z._buf, z.members = "mem", data, {}
    z._scan()
    assert z.read("a") == b"xyz" and z.json("b/c.json") == {"k": 1} and "b/c.json" in z
    bad = bytearray(data)
    bad[8] = 8  # method: deflate
    z._buf, z.members = bytes(bad), {}
    with pytest.raises(ValueError, match="compressed member"):
        z._scan()
