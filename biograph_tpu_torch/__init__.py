"""biograph_tpu_torch — the PyTorch/CUDA port of biograph_tpu.

Same capabilities, same sub-package layout (``core/``, ``ops/``, ``index/``,
``build/``, ``io/``) as the JAX package, so the counterpart of a module is
found by path.  Plain tensor code is PyTorch; the hot kernels are CUDA C++
under ``csrc/``, built at first use (see ``ops/_build.py``).

Device rule: every entry point takes an explicit ``device`` argument that
defaults to ``"cuda"`` and raises when CUDA is absent.  There is no "cuda if
available else cpu": a caller that wants the CPU (the tests do) says so.

Integer widths: entry ids, range ends, ``pop_sel`` and ``prev_cum`` are
``torch.int64``; sizes, ``shared`` and lengths are ``torch.int32``.

The package exports what the JAX package's does: ``dna``, the SDK objects
``BioGraph`` and ``Sequence``, ``Seqset``, ``SeqsetRanges``, ``Readmap``,
``Reference``, ``version`` and ``build_revision``.  ``resolve_device`` is
defined before those imports, since their modules import it from here.
"""

import torch as _torch

__version__ = "0.1.0"


def version() -> str:
    return __version__


def resolve_device(device="cuda") -> _torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    Raises RuntimeError for a CUDA device when CUDA is not available; never
    substitutes another device."""
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' explicitly to run on the host"
        )
    return dev


def build_revision() -> str:
    """The checkout's git revision, or "unknown"."""
    import os
    import subprocess

    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True,
            text=True,
            timeout=5,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


from biograph_tpu_torch.core import dna  # noqa: E402
from biograph_tpu_torch.api import BioGraph, Sequence  # noqa: E402
from biograph_tpu_torch.index.seqset import Seqset, SeqsetRanges  # noqa: E402
from biograph_tpu_torch.index.readmap import Readmap  # noqa: E402
from biograph_tpu_torch.index.reference import Reference  # noqa: E402

__all__ = [
    "dna",
    "BioGraph",
    "Sequence",
    "Seqset",
    "SeqsetRanges",
    "Readmap",
    "Reference",
    "version",
    "build_revision",
    "resolve_device",
]
