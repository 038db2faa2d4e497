"""The prefix-partitioned build of the PyTorch port: under a budget its own
plan cannot hold in memory, the build takes passes and its result equals
the one-shot build's and the JAX package's in every field, on
``tests/test_partitioned_build.py``'s three input shapes (random reads of
mixed length; duplicates and reads shorter than the partition depth;
memmap reads streamed in chunks)."""

import numpy as np
import pytest
import torch

from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu_torch.build import seqset_build as sb
from biograph_tpu_torch.convert import SEQSET_DTYPES, seqset_to_numpy
from biograph_tpu_torch.runtime import resources
from biograph_tpu_torch.runtime.resources import MemoryBudget


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_reads(rng):
    codes = rng.integers(0, 4, (400, 50)).astype(np.uint8)
    lens = rng.integers(20, 51, 400).astype(np.int32)
    return np.where(np.arange(50)[None, :] < lens[:, None], codes, 0).astype(np.uint8), lens


def duplicates_and_short_reads(rng):
    rows = [rng.integers(0, 4, 30).astype(np.uint8) for _ in range(40)]
    rows += rows[:10]  # exact duplicate reads
    codes = np.zeros((len(rows), 30), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        n = 30 if i % 3 else 7  # some reads shorter than the partition depth
        codes[i, :n] = r[:n]
        lens[i] = n
    return codes, lens


def memmap_reads(rng, tmp_path):
    R, L = 900, 40
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    lens = rng.integers(25, 41, R).astype(np.int32)
    codes = np.where(np.arange(L)[None, :] < lens[:, None], codes, 0).astype(np.uint8)
    mp = np.memmap(str(tmp_path / "reads.u8"), np.uint8, "w+", shape=(R, L))
    mp[:] = codes
    mp.flush()
    return np.memmap(str(tmp_path / "reads.u8"), np.uint8, "r", shape=(R, L)), lens


CASES = {
    "random_400x50": (random_reads, 1 << 20),
    "duplicates_and_short_reads": (duplicates_and_short_reads, MemoryBudget(bytes=1 << 16)),
    "memmap_reads": (memmap_reads, 1 << 17),
}


def assert_same(got, want):
    """Every field of a port seqset equals a port's or a JAX package's."""
    a = seqset_to_numpy(got)
    assert a["n_entries"] == want.n_entries and a["max_entry_len"] == want.max_entry_len
    b = seqset_to_numpy(want) if isinstance(want.fixed, torch.Tensor) else {k: np.asarray(getattr(want, k)) for k in SEQSET_DTYPES}
    for name in SEQSET_DTYPES:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_partitioned_equals_one_shot_and_jax(case, tmp_path):
    make, budget = CASES[case]
    rng = np.random.default_rng(12345)
    codes, lens = make(rng, tmp_path) if case == "memmap_reads" else make(rng)
    host = np.asarray(codes)
    one_shot = sb.build_seqset(host, lens, device="cpu")
    assert one_shot.build_info["plan"].in_memory and one_shot.build_info["passes"] == 1
    parted = sb.build_seqset(codes, lens, budget=budget, device="cpu")
    plan = parted.build_info["plan"]
    assert not plan.in_memory and plan.sort_bytes > getattr(budget, "bytes", budget)
    assert parted.build_info["passes"] >= 2
    if case == "memmap_reads":
        assert plan.chunk_rows < len(lens)  # streamed in several chunks
    assert_same(parted, one_shot)
    assert_same(parted, jax_build_seqset(host, lens))
    e_words, e_lens = parted.__dict__["_entry_cache"]
    ow, ol = one_shot.__dict__["_entry_cache"]
    assert torch.equal(e_words, ow) and torch.equal(e_lens, ol)


def test_plan_counts_the_ports_bytes():
    """The plan's bytes a row are the port's own: SORT_ROW_COPIES rows of
    W int64 words and an int32 length (the JAX package counts 4 x (4 W + 8));
    the in-memory decision and the passes come from that count."""
    assert sb.suffix_row_bytes(7) == 4 * 60 == 240
    assert sb.suffix_row_bytes(4) == 144
    assert sb.chunk_read_bytes(100, 7) == 64 * 212
    rows, W, L = 24_000_000, 7, 100
    assert sb.build_plan(rows, W, L, None).in_memory
    assert sb.build_plan(rows, W, L, rows * 240).in_memory
    plan = sb.build_plan(rows, W, L, rows * 240 - 1)
    assert not plan.in_memory and plan.sort_bytes == rows * 240
    assert plan.chunk_rows == (rows * 240 - 1) // 8 // (64 * 212)
    assert plan.per_pass_rows == (rows * 240 - 1 - plan.chunk_rows * 64 * 212) // 240
    assert rows / 4**plan.d <= plan.per_pass_rows / 4 < rows / 4 ** (plan.d - 1)
    # where the JAX package's count (144 B a row) would sort in memory, the port's does not
    assert rows * 4 * (4 * W + 8) <= 4 << 30 < rows * 240
    assert not sb.build_plan(rows, W, L, 4 << 30).in_memory
    tiny = sb.build_plan(10_000, 2, 30, 1 << 10)
    assert (tiny.per_pass_rows, tiny.chunk_rows) == (sb.MIN_PASS_ROWS, sb.MIN_CHUNK_ROWS)


def test_pass_ranges():
    counts = np.array([0, 5, 0, 0, 7, 3, 0, 20, 1, 0, 0], np.int64)
    assert sb.pass_ranges(counts, 10) == [(0, 4), (4, 7), (7, 8), (8, 11)]
    assert sb.pass_ranges(counts, 100) == [(0, 11)]
    assert sb.pass_ranges(np.zeros(4, np.int64), 10) == [(0, 4)]


def test_memory_budget(monkeypatch):
    assert MemoryBudget.detect("cpu").bytes == 4 << 30
    assert MemoryBudget.detect("cpu", fraction=0.25).bytes == 2 << 30
    budget = MemoryBudget(bytes=1000)
    assert budget.fits(1000) and not budget.fits(1001)
    assert (budget.passes_needed(1), budget.passes_needed(1000), budget.passes_needed(2001)) == (1, 1, 3)
    monkeypatch.setattr(resources, "BUDGET_BYTES", 12345)
    assert MemoryBudget.detect("cpu").bytes == 12345
    if not torch.cuda.is_available():
        monkeypatch.setattr(resources, "BUDGET_BYTES", None)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MemoryBudget.detect()


def test_empty_read_sets_raise():
    with pytest.raises(ValueError, match="no nonempty reads"):
        sb.build_seqset(np.zeros((0, 10), np.uint8), np.zeros(0, np.int32), budget=1 << 10, device="cpu")
    with pytest.raises(ValueError, match="no nonempty reads"):
        sb.build_seqset(np.zeros((3, 10), np.uint8), np.zeros(3, np.int32), budget=1 << 10, device="cpu")
