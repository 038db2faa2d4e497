"""The port's ``io/vcf.VcfWriter`` against the JAX package's: the same
records written by both, one sample and several, to a path, to an open
file and to ``.gz``; the bytes equal but for the ``##source=`` line, which
names each package.

Run alone on the CPU:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_vcf_writer.py -q``.
"""

import gzip
import io

import numpy as np
import pytest

from biograph_tpu.io import vcf as jvcf
from biograph_tpu_torch.io import vcf as tvcf

SAMPLES = ["father", "mother", "proband"]
HEADERS = ['##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">', '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="x">']


def records(module, n_samples, seed=5, n=40):
    """Seeded records on two contigs, each with a fmt of n_samples dicts
    (one dict when n_samples is None): GT text, GQ int, AD text, DP int,
    the keys of the first sample in an order of their own."""
    rng = np.random.default_rng(seed)
    out = []
    for chrom in ("chr1", "chr2"):
        pos = 1
        for _ in range(n // 2):
            pos += int(rng.integers(0, 30))
            ref = "".join("ACGT"[b] for b in rng.integers(0, 4, int(rng.integers(1, 4))))
            alt = ",".join("".join("ACGT"[b] for b in rng.integers(0, 4, int(rng.integers(1, 5)))) for _ in range(int(rng.integers(1, 3))))
            fmts = []
            for _ in range(n_samples or 1):
                f = {"GT": ["0/0", "0/1", "1/1", "./."][int(rng.integers(0, 4))], "GQ": int(rng.integers(0, 99)),
                     "AD": f"{int(rng.integers(0, 40))},{int(rng.integers(0, 40))}", "DP": int(rng.integers(0, 80))}
                if rng.random() < 0.2:
                    del f["GQ"]  # a key the first sample may lack, or a later one
                fmts.append(f)
            info = {"SVLEN": len(alt) - len(ref)} if rng.random() < 0.5 else {}
            if rng.random() < 0.2:
                info["IMPRECISE"] = True
            qual = None if rng.random() < 0.2 else float(rng.integers(0, 500)) / 7
            out.append(module.VcfRecord(chrom, pos, ref, alt, qual=qual, filter=["PASS", "lowq"][int(rng.integers(0, 2))], info=info,
                                        fmt=fmts[0] if n_samples is None else fmts))
    return out


def write(module, target, sample, n_samples):
    with module.VcfWriter(target, sample=sample, contigs=[("chr1", 10_000), ("chr2", 5000)], extra_headers=HEADERS) as w:
        for r in records(module, n_samples):
            w.write(r)


def split_source(text):
    lines = text.splitlines(keepends=True)
    source = [ln for ln in lines if ln.startswith("##source=")]
    return source, [ln for ln in lines if not ln.startswith("##source=")]


def assert_same_but_source(jax_text, torch_text):
    (js, jrest), (ts, trest) = split_source(jax_text), split_source(torch_text)
    assert js == ["##source=biograph_tpu\n"] and ts == ["##source=biograph_tpu_torch\n"]
    assert jrest == trest


CASES = {"single": ("S1", None), "multi": (SAMPLES, 3), "multi_one_name": (["only"], 1)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("target", ["path", "gz", "open_file"])
def test_writers_write_the_same_bytes(tmp_path, case, target):
    sample, n_samples = CASES[case]
    texts = []
    for name, module in (("jax", jvcf), ("torch", tvcf)):
        if target == "open_file":
            f = io.StringIO()
            write(module, f, sample, n_samples)
            assert not f.closed  # a file the caller opened stays open
            texts.append(f.getvalue())
            continue
        path = str(tmp_path / (f"{name}.vcf" + (".gz" if target == "gz" else "")))
        write(module, path, sample, n_samples)
        opener = gzip.open if target == "gz" else open
        with opener(path, "rt") as f:
            texts.append(f.read())
    assert_same_but_source(*texts)
    header = [ln for ln in texts[1].splitlines() if ln.startswith("#CHROM")][0]
    assert header.split("\t")[9:] == ([sample] if isinstance(sample, str) else sample)


def test_f1_two_samples(tmp_path):
    """The smallest case of the fault the writer had: two names and a list
    of two format dicts."""
    texts = []
    for name, module in (("jax", jvcf), ("torch", tvcf)):
        path = str(tmp_path / f"{name}.vcf")
        with module.VcfWriter(path, sample=["a", "b"]) as w:
            w.write(module.VcfRecord("chr1", 10, "A", "T", fmt=[{"GT": "0/1"}, {"GT": "1/1"}]))
        texts.append(open(path).read())
    assert_same_but_source(*texts)
    lines = texts[1].splitlines()
    assert lines[-2].endswith("FORMAT\ta\tb") and lines[-1].endswith("GT\t0/1\t1/1")


def test_source_argument_and_order_canary(tmp_path):
    f = io.StringIO()
    with tvcf.VcfWriter(f, source="elsewhere") as w:
        w.write(tvcf.VcfRecord("chr1", 5, "A", "C"))
        with pytest.raises(ValueError, match="order violation"):
            w.write(tvcf.VcfRecord("chr1", 4, "A", "C"))
    assert "##source=elsewhere\n" in f.getvalue()
    # the reader keeps the first sample of a multi-sample file
    path = str(tmp_path / "m.vcf")
    with tvcf.VcfWriter(path, sample=["a", "b"]) as w:
        w.write(tvcf.VcfRecord("chr1", 10, "A", "T", fmt=[{"GT": "0/1", "DP": 3}, {"GT": "1/1", "DP": 4}]))
    assert [r.fmt for r in tvcf.read_vcf(path)] == [r.fmt for r in jvcf.read_vcf(path)] == [{"GT": "0/1", "DP": "3"}]
