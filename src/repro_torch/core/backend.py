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
tensors (core/s2fp8.py ``as_stats``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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
