"""The plain reference of the discovery cells on cases worked by hand."""

import numpy as np
import pytest

from benchmark.lib import reference

G = np.array([0, 1, 2, 3, 3, 3, 1, 0, 2, 2, 1], np.uint8)  # ACGTTTCAGGC


@pytest.mark.parametrize(
    "pos, ref, alt, want",
    [
        (6, "C", "G", (6, "C", "G")),  # an SNV stays
        (5, "TC", "C", (2, "GT", "G")),  # a T deleted at the end of TTT shifts to its start
        (5, "T", "TT", (2, "G", "GT")),  # a T inserted in TTT
        (7, "AG", "A", (7, "AG", "A")),  # no repeat: stays
        (3, "TTT", "T", (2, "GTT", "G")),
    ],
)
def test_left_normalize(pos, ref, alt, want):
    assert reference.left_normalize(G, pos, ref, alt) == want


def test_hap_position_maps_around_edits():
    # insert 2 bases before 3, delete 6 and 7
    pos = reference.hap_position(11, [(3, 0, np.array([0, 0], np.uint8)), (6, 2, np.zeros(0, np.uint8))])
    assert pos.tolist() == [0, 1, 2, 5, 6, 7, -1, -1, 8, 9, 10]


def _reads_of(hap, starts, L):
    """Error-free untrimmed pairs with fragment L (read 2 the reverse
    complement of the same bases), in the generator's layout."""
    n = len(starts)
    codes = np.zeros((2 * n, L), np.uint8)
    for i, s in enumerate(starts):
        codes[2 * i] = hap[s : s + L]
        codes[2 * i + 1] = (3 - hap[s : s + L])[::-1]
    truth_reads = {"hap_of": np.zeros(n, np.int64), "start": np.array(starts, np.int64), "frag": np.full(n, L, np.int64)}
    return codes, np.full(2 * n, L, np.int32), truth_reads


def test_support_counts_reads_that_carry_the_variant_exactly():
    rng = np.random.default_rng(3)
    g = rng.integers(0, 4, 3000, dtype=np.uint8)
    hap = g.copy()
    hap[1500] = (g[1500] + 1) % 4
    L = 50
    # 6 pairs cover 1500 with a base on each side; 2 pairs end before it
    starts = [1452, 1460, 1470, 1480, 1490, 1449, 1400, 1420]
    codes, lengths, reads = _reads_of(hap, starts, L)
    small = [(1500, "ACGT"[g[1500]], "ACGT"[hap[1500]], 2)]
    truth = {"small": small, "haps": [hap, hap], "edits": [[], []], "sv": [], **reads}
    ex = reference.expected_calls(g, truth, codes, lengths, L, min_alt_support=3)
    v = reference.left_normalize(g, *small[0][:3])
    # each pair is two reads, one a strand: 2 x 5 reads hold 1499..1501
    assert ex.support[v] == 10
    rec = {"pos": 1501, "ref": v[1], "alt": v[2], "support": 10}
    assert reference.judge([rec], ex) == {"missed": 0, "extra": 0, "support_off": 0}
    assert reference.judge([], ex)["missed"] == 1
    assert reference.judge([dict(rec, support=9)], ex)["support_off"] == 1
    assert reference.judge([rec, dict(rec, pos=1201, ref="A", alt="C")], ex)["extra"] == 1
