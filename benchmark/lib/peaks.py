"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet), copied
from ``chip_smoke.py`` (:238-239, ``PEAK_BYTES_PER_S``/``PEAK_OPS_PER_S``)
at commit 3444720.  They hold at the card's full power limit; a share of a
peak is stated with the card's ``power.limit`` beside it."""

POWER_LIMIT_W = 700.0  # the limit the data sheet's rates assume
PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_OPS_PER_S = 67e12  # 32-bit integer and float operations outside the tensor cores
L2_BYTES = 50 * 2**20
