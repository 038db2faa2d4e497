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
