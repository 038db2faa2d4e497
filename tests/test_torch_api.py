"""The SDK objects of the PyTorch port (``biograph_tpu_torch/api.py``)
against the JAX package's: the cases of tests/test_api.py on the port
(without the one that opens a reference archive on disk, and without the
genotyper, which is not ported), each result held to the JAX package's on
the same archive; and a ``.bgt`` saved by either package opened by the
other.  Tolerance: exact equality."""

import json
import os

import numpy as np
import pytest
import torch

import biograph_tpu_torch
from biograph_tpu.api import BioGraph as JBioGraph
from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu_torch.api import BioGraph, ReferenceRange, Sequence
from biograph_tpu_torch.build.readmap_build import build_readmap
from biograph_tpu_torch.build.seqset_build import build_seqset
from biograph_tpu_torch.core import dna
from biograph_tpu_torch.index.reference import Contig, Reference


def _sample(rng):
    """tests/test_api.py's sample: 300 reads of 30 bases over a 1500-base
    genome."""
    genome = rng.integers(0, 4, size=1500, dtype=np.uint8)
    starts = rng.integers(0, 1500 - 30, size=300)
    codes = np.stack([genome[s : s + 30] for s in starts])
    return genome, codes, np.full(300, 30, np.int32)


def _write_bgt(d, ss, rm):
    os.makedirs(d, exist_ok=True)
    ss.save(os.path.join(d, "seqset"))
    rm.save(os.path.join(d, "readmap"))
    with open(os.path.join(d, "metadata.json"), "w") as f:
        json.dump({"accession_id": "t"}, f)
    return d


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """The same sample saved by the JAX package and by the port."""
    genome, codes, lens = _sample(np.random.default_rng(11))
    root = tmp_path_factory.mktemp("bgt")
    js = jax_build_seqset(codes, lens)
    jax_path = _write_bgt(str(root / "jax.bgt"), js, jax_build_readmap(js, codes, lens))
    ts = build_seqset(codes, lens, device="cpu")
    port_path = _write_bgt(str(root / "port.bgt"), ts, build_readmap(ts, codes, lens, device="cpu"))
    return dict(jax=jax_path, port=port_path, genome=genome, codes=codes)


def test_sequence_ops():
    s = Sequence("ACGTT")
    assert str(s) == "ACGTT"
    assert len(s) == 5
    assert s.rev_comp() == "AACGT"
    assert s[1:3] == "CG"
    assert Sequence(torch.tensor([0, 1, 2, 3], dtype=torch.uint8)) == Sequence("ACGT")


def _entry_tuple(e):
    return (e.begin, e.end, e.size)


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_biograph_bgt_roundtrip(archives, saved_by):
    """tests/test_api.py::test_biograph_bgt_roundtrip on the port, each
    answer held to the JAX package's BioGraph on the same archive."""
    path, genome, codes = archives[saved_by], archives["genome"], archives["codes"]
    bg, jbg = BioGraph(path, device="cpu"), JBioGraph(path)
    assert bg.num_reads == jbg.num_reads == 300
    assert bg.metadata == jbg.metadata == {"accession_id": "t"}
    assert bg.seqset.device.type == "cpu" and repr(bg) == repr(jbg)
    read = dna.codes_to_seq(codes[0])
    e, je = bg.find(read), jbg.find(read)
    assert e.valid and _entry_tuple(e) == _entry_tuple(je)
    assert str(e.sequence())[: len(read)] == read == str(je.sequence())[: len(read)]
    popped = e.pop_front()
    assert popped.size == e.size - 1 and _entry_tuple(popped) == _entry_tuple(je.pop_front())
    for n in (0, 5, 12, 29, 40):
        assert _entry_tuple(e.truncate(n)) == _entry_tuple(je.truncate(n))
    for base in "ACGT":
        assert _entry_tuple(popped.push_front(base)) == _entry_tuple(je.pop_front().push_front(base))
    # pop to the empty sequence and back along the read
    walk, jwalk = e, je
    for _ in range(e.size):
        walk, jwalk = walk.pop_front(), jwalk.pop_front()
        assert _entry_tuple(walk) == _entry_tuple(jwalk)
    assert _entry_tuple(walk) == (0, bg.seqset.n_entries, 0)
    assert str(bg.entry(3).sequence(10)) == str(jbg.entry(3).sequence(10))
    cov = bg.seq_coverage(dna.codes_to_seq(genome[200:260]))
    np.testing.assert_array_equal(cov, jbg.seq_coverage(dna.codes_to_seq(genome[200:260])))
    assert cov.max() >= 1


def test_biograph_missing_and_bg_and_the_device(tmp_path, archives):
    with pytest.raises(FileNotFoundError):
        BioGraph(str(tmp_path / "nope"), device="cpu")
    bg_dir = tmp_path / "sample.bg"
    os.makedirs(bg_dir)
    (bg_dir / "seqset").write_bytes(b"PK")  # the reference's layout: a file, not a dir
    with pytest.raises(NotImplementedError, match="bgimport"):
        BioGraph(str(bg_dir), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BioGraph(archives["port"])


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_sdk_read_handles_and_ranges(archives, saved_by):
    """tests/test_api.py::test_sdk_read_handles_and_ranges on the port, each
    answer held to the JAX package's."""
    path, genome = archives[saved_by], archives["genome"]
    bg, jbg = BioGraph(path, device="cpu"), JBioGraph(path)
    for rm_id in (0, 1, 77, 599):
        r, jr = bg.read(rm_id), jbg.read(rm_id)
        assert (r.length, r.is_forward, r.read_id, r.entry_id) == (jr.length, jr.is_forward, jr.read_id, jr.entry_id)
        s = r.sequence()
        assert len(s) == r.length and str(s) == str(jr.sequence())
        rc = r.rev_comp()
        assert rc.rm_id == jr.rev_comp().rm_id and rc.length == r.length
        assert str(rc.sequence()) == str(s.rev_comp())
        assert (r.mate() is None) == (jr.mate() is None)
        assert repr(r) == repr(jr)
    stats = bg.pair_stats()
    assert stats == jbg.pair_stats()
    assert stats["paired_reads"] + stats["unpaired_reads"] == bg.num_reads

    ref = Reference(flat=genome, is_n=(genome == 255), contigs=[Contig("g", 0, len(genome))])
    rr = ref.make_range("g", 100, 160)
    assert isinstance(rr, ReferenceRange) and rr.size == 60
    assert str(rr.sequence()) == dna.codes_to_seq(genome[100:160])
    assert repr(rr) == "ReferenceRange(g:100-160)"
    with pytest.raises(ValueError):
        ref.make_range("g", 50, len(genome) + 1)
    assert biograph_tpu_torch.version() == biograph_tpu_torch.__version__
    assert isinstance(biograph_tpu_torch.build_revision(), str)


def test_package_exports():
    import biograph_tpu

    for name in biograph_tpu.__all__ + ["version", "build_revision"]:
        assert hasattr(biograph_tpu_torch, name), name
    assert biograph_tpu_torch.BioGraph is BioGraph and biograph_tpu_torch.Seqset.__module__ == "biograph_tpu_torch.index.seqset"
