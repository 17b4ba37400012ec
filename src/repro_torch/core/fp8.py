"""FP8 format constants and the raw e5m2 truncation (port of
``repro.core.fp8``).

e5m2 is IEEE-style 1/5/2 with denormals (paper Table A1), which is
``torch.float8_e5m2``; e4m3 is ``torch.float8_e4m3fn``.  ``.to(dtype)``
rounds to nearest even, bit for bit like ml_dtypes' casts.
"""
import torch

E5M2_MAX = 57344.0          # (1 - 2**-3) * 2**16
E4M3_MAX = 448.0


def truncate_e5m2(x: torch.Tensor) -> torch.Tensor:
    """RNE-truncate to e5m2 and return in ``x``'s dtype.  Unclamped on
    purpose: raw FP8 overflows to inf, the divergence the paper
    documents."""
    return x.to(torch.float8_e5m2).to(x.dtype)
