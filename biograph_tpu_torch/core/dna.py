"""2-bit DNA codec and packed-word sequence utilities (torch).

Counterpart of ``biograph_tpu/core/dna.py``.  Sequences live as:

  * **codes**: uint8 tensors (or numpy arrays on the host I/O side) of
    per-base codes A=0 C=1 G=2 T=3, one base per element.
  * **packed words**: 16 bases per 32-bit word, first base in the two most
    significant bits.  With zero padding past the sequence end, unsigned
    word-by-word comparison equals lexicographic DNA comparison; ties
    between a sequence and itself + trailing A's are broken by an explicit
    ascending length key ("prefix-first" order, the seqset entry order).

Representation: torch has no arithmetic on ``uint32``, so packed words are
``torch.int64`` tensors holding the 32-bit value in [0, 2**32) (every
producer masks with ``& 0xFFFFFFFF``).  Signed comparison of such values is
unsigned comparison of the words.  ``u32_to_i32`` / ``i32_to_u32`` convert
to and from the bit-reinterpreted ``int32`` form that the rank structure
stores.  The k-mer helpers are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

BASES_PER_WORD = 16  # 2 bits per base in a 32-bit word
MASK32 = 0xFFFFFFFF

_ASCII_TO_CODE = np.zeros(256, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _ASCII_TO_CODE[ord(_ch)] = _code
    _ASCII_TO_CODE[ord(_ch.lower())] = _code
# Every other character (incl. 'N') maps to 0 == 'A'.

_CODE_TO_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_ascii(buf: np.ndarray) -> np.ndarray:
    """uint8 ASCII array -> uint8 base codes (host)."""
    return _ASCII_TO_CODE[buf]


def decode_to_ascii(codes: np.ndarray) -> np.ndarray:
    """uint8 base codes -> uint8 ASCII array (host)."""
    return _CODE_TO_ASCII[np.asarray(codes) & 3]


def seq_to_codes(seq: str) -> np.ndarray:
    return encode_ascii(np.frombuffer(seq.encode(), dtype=np.uint8))


def codes_to_seq(codes) -> str:
    if isinstance(codes, torch.Tensor):
        codes = codes.cpu().numpy()
    return decode_to_ascii(np.asarray(codes)).tobytes().decode()


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit value -> the same bits as int32."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """bit-reinterpreted int32 -> int64 holding the 32-bit value."""
    return x.to(torch.int64) & MASK32


def revcomp_codes(codes: torch.Tensor, length=None) -> torch.Tensor:
    """Reverse complement of a code tensor along its last axis.

    With ``length`` given (per-row lengths for a padded 2-D batch), each row
    is reversed within its own length; the padding region is zeroed.
    """
    comp = (3 - codes).to(codes.dtype)
    if length is None:
        return torch.flip(comp, dims=(-1,))
    n = codes.shape[-1]
    idx = torch.arange(n, device=codes.device)
    lengths = torch.as_tensor(length, device=codes.device)[..., None]
    src = lengths - 1 - idx
    valid = idx < lengths
    src = torch.where(valid, src, 0)
    out = torch.gather(comp, -1, src.to(torch.int64))
    return torch.where(valid, out, 0).to(codes.dtype)


def words_for_bases(nbases: int) -> int:
    return (nbases + BASES_PER_WORD - 1) // BASES_PER_WORD


def _shifts(device) -> torch.Tensor:
    return 2 * (
        BASES_PER_WORD - 1 - torch.arange(BASES_PER_WORD, device=device)
    )


def pack_codes(codes: torch.Tensor, lengths=None) -> torch.Tensor:
    """Pack base codes into 32-bit words, first base in the top two bits.

    codes: [..., L] uint8 with zero padding; returns [..., W] int64 (32-bit
    values) where W = ceil(L/16).  Bases beyond ``lengths`` (if given) are
    zeroed first.
    """
    L = codes.shape[-1]
    W = words_for_bases(L)
    padL = W * BASES_PER_WORD
    c = codes.to(torch.int64)
    if lengths is not None:
        pos = torch.arange(L, device=codes.device)
        lengths = torch.as_tensor(lengths, device=codes.device)
        c = torch.where(pos < lengths[..., None], c, 0)
    if padL != L:
        c = torch.nn.functional.pad(c, (0, padL - L))
    c = c.reshape(c.shape[:-1] + (W, BASES_PER_WORD))
    return (c << _shifts(codes.device)).sum(dim=-1)


def unpack_words(words: torch.Tensor, nbases: int) -> torch.Tensor:
    """Inverse of pack_codes: [..., W] int64 words -> [..., nbases] uint8."""
    W = words.shape[-1]
    c = (words[..., :, None] >> _shifts(words.device)) & 3
    c = c.reshape(words.shape[:-1] + (W * BASES_PER_WORD,))
    return c[..., :nbases].to(torch.uint8)


def prefix_mask_words(length, W: int, device=None) -> torch.Tensor:
    """Per-word AND-masks selecting the first ``length`` bases of a W-word
    row.  length: scalar or [...]; returns [..., W] int64 (32-bit values)."""
    if isinstance(length, torch.Tensor) and device is None:
        device = length.device
    length = torch.as_tensor(length, device=device).to(torch.int64)
    widx = torch.arange(W, device=length.device)
    # bases covered by each word: clamp(length - 16*w, 0, 16)
    inword = torch.clamp(
        length[..., None] - widx * BASES_PER_WORD, 0, BASES_PER_WORD
    )
    shift = 2 * (BASES_PER_WORD - inword)
    # the top 2*inword bits set; inword == 0 shifts everything out
    return ((MASK32 >> shift) << shift) & MASK32
