"""Numerics-backend registry of the port: one interface, two engines.

Counterpart of ``repro.core.backend`` with its own two-entry table
(nothing is registered into the JAX package's registry):

  * ``"plain"`` — plain PyTorch (core/s2fp8.py + kernels/ref.py) on any
    device; the counterpart of the reference's ``RefBackend``;
  * ``"cuda"``  — the hand-written kernels through kernels/dispatch.py; the
    counterpart of ``PallasBackend``.  Its wrappers launch the CUDA kernel
    for a CUDA tensor and take the kernel's plain version for a CPU tensor,
    which is how the CPU tests run this engine.

``"auto"`` resolves to ``"cuda"``.  (alpha, beta) travel as f32 [2]
tensors (core/s2fp8.py ``as_stats``).  The stats reduction is a torch
reduction on both engines (the reference's exact-stats engine runs it
outside any Pallas kernel too).

Also here, as in the reference: ``bidir_truncate`` (the exact-stats
differentiable truncation per engine) and ``plan_qdot_general`` (how a
contraction maps onto the 2-D payload GEMM layouts).
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import s2fp8
from repro_torch.core.s2fp8 import S2FP8Tensor


class NumericsBackend:
    """Interface every engine implements.  ``stats`` is (alpha, beta) as an
    f32 [2] tensor or a pair: serving quantizes with frozen or calibrated
    stats, never with per-call ones."""

    name = "abstract"

    def compute_stats_partials(self, x: torch.Tensor
                               ) -> Tuple[torch.Tensor, ...]:
        return s2fp8.compute_stats_partials(x)

    def compute_stats(self, x: torch.Tensor, *, fmt: str = "e5m2"
                      ) -> torch.Tensor:
        """Exact (alpha, beta) of ``x`` for ``fmt``'s range, f32 [2]."""
        return s2fp8.compute_stats(x, s2fp8.FMT_TARGET_MAX[fmt])

    def quantize(self, x: torch.Tensor, *, stats,
                 fmt: str = "e5m2") -> S2FP8Tensor:
        raise NotImplementedError

    def dequantize(self, t: S2FP8Tensor, dtype=torch.float32) -> torch.Tensor:
        return s2fp8.dequantize(t, dtype)

    def truncate(self, x: torch.Tensor, *, stats,
                 fmt: str = "e5m2") -> torch.Tensor:
        raise NotImplementedError

    def qmatmul(self, a: S2FP8Tensor, b: S2FP8Tensor, *, layout: str = "nn",
                epilogue_stats=None, fmt: str = "e5m2") -> torch.Tensor:
        """Payload GEMM on 2-D payloads; ``epilogue_stats`` fuses the output
        site's Eq. 5 truncation (on the ``fmt`` grid)."""
        raise NotImplementedError

    def __repr__(self):
        return f"<NumericsBackend {self.name!r}>"


class PlainBackend(NumericsBackend):
    """Plain PyTorch engine (the reference's ``ref`` counterpart)."""

    name = "plain"

    def quantize(self, x, *, stats, fmt="e5m2"):
        return s2fp8.quantize(x, stats=s2fp8.as_stats(stats, x.device),
                              fmt=fmt)

    def truncate(self, x, *, stats, fmt="e5m2"):
        from repro_torch.kernels import ref
        return ref.s2fp8_truncate_ref(x, stats=s2fp8.as_stats(
            stats, x.device), fmt=fmt)

    def qmatmul(self, a, b, *, layout="nn", epilogue_stats=None, fmt="e5m2"):
        from repro_torch.kernels import ref
        oab = (None if epilogue_stats is None
               else s2fp8.as_stats(epilogue_stats, a.payload.device))
        return ref.s2fp8_matmul_ref(a.payload, a.ab, b.payload, b.ab, oab,
                                    layout=layout, fmt=fmt)


class CudaBackend(NumericsBackend):
    """Hand-written CUDA kernels (the reference's ``pallas`` counterpart)."""

    name = "cuda"

    def quantize(self, x, *, stats, fmt="e5m2"):
        from repro_torch.kernels import dispatch
        ab = s2fp8.as_stats(stats, x.device)
        return S2FP8Tensor(dispatch.quant_nd(x, ab, fmt), ab, fmt)

    def dequantize(self, t, dtype=torch.float32):
        from repro_torch.kernels import dispatch
        return dispatch.dequant_nd(t.payload, t.ab, dtype)

    def truncate(self, x, *, stats, fmt="e5m2"):
        from repro_torch.kernels import dispatch
        return dispatch.truncate_nd(x, s2fp8.as_stats(stats, x.device), fmt)

    def qmatmul(self, a, b, *, layout="nn", epilogue_stats=None, fmt="e5m2"):
        from repro_torch.kernels import dispatch
        return dispatch.qmatmul_nd(a.payload, a.ab, b.payload, b.ab,
                                   layout=layout,
                                   epilogue_stats=epilogue_stats, fmt=fmt)


BACKENDS: Dict[str, NumericsBackend] = {"plain": PlainBackend(),
                                         "cuda": CudaBackend()}


def get_backend(name: Optional[str] = None) -> NumericsBackend:
    """Resolve a backend by name; ``None``/"auto" is the ``cuda`` engine."""
    if name is None or name == "auto":
        name = "cuda"
    try:
        return BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown numerics backend {name!r}; "
                       f"want one of {tuple(BACKENDS)}") from None


# ---------------------------------------------------------------------------
# differentiable exact-stats truncation per engine (reference backend.py:555)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def bidir_truncate(backend: Optional[str] = None, fmt: str = "e5m2"):
    """Eq. 5 with fresh exact stats on the forward value AND on the
    cotangent, through the named engine (one callable per (engine,
    format))."""

    def trunc(x):
        be = get_backend(backend)
        return be.truncate(x, stats=be.compute_stats(x, fmt=fmt), fmt=fmt)

    class _Bidir(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return trunc(x)

        @staticmethod
        def backward(ctx, g):
            return trunc(g)

    return _Bidir.apply


# ---------------------------------------------------------------------------
# contraction planning (reference backend.py:159-262, the 2-D part)
# ---------------------------------------------------------------------------

class QdotPlan(NamedTuple):
    """How one contraction maps onto a 2-D payload GEMM: the kernel layout,
    the operands' 2-D reshape targets and the final output shape.  The
    batched fields of the reference wait for the batched GEMM."""

    layout: str
    a2_shape: Tuple[int, ...]
    b2_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]


def _prod(dims) -> int:
    p = 1
    for d in dims:
        p *= d
    return p


def plan_qdot_general(a_shape, b_shape, dimension_numbers
                      ) -> Optional[QdotPlan]:
    """Map a batch-free dot_general onto a 2-D payload GEMM, or None.

    One contracting dim per operand, at the boundary of its free dims (the
    rest flatten contiguously); the output is ``a_free + b_free``.  This
    covers the dense ``...k,kn->...n`` GEMMs ("nn") and the tied LM head
    ``x . E^T`` contracting both last dims ("nt"), and ``k...,kn`` ("tn").
    Batch dims (the reference's batched GEMM) and the "tt" case have no
    kernel here and give None."""
    (ca, cb), (batch_a, batch_b) = dimension_numbers
    if batch_a or batch_b or len(ca) != 1 or len(cb) != 1:
        return None
    ca, cb = ca[0], cb[0]
    if ca not in (0, len(a_shape) - 1) or cb not in (0, len(b_shape) - 1):
        return None
    a_last = ca == len(a_shape) - 1
    b_first = cb == 0
    if not a_last and not b_first:
        return None                      # "tt": no layout variant
    k = a_shape[ca]
    if k != b_shape[cb]:
        return None
    a_rest = tuple(d for i, d in enumerate(a_shape) if i != ca)
    b_rest = tuple(d for i, d in enumerate(b_shape) if i != cb)
    m, n = _prod(a_rest), _prod(b_rest)
    if 0 in (m, k, n):
        return None
    if a_last and b_first:
        layout, a2, b2 = "nn", (m, k), (k, n)
    elif a_last:
        layout, a2, b2 = "nt", (m, k), (n, k)
    else:
        layout, a2, b2 = "tn", (k, m), (k, n)
    return QdotPlan(layout, a2, b2, a_rest + b_rest)
