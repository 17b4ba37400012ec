"""Numeric policy of the port: how every GEMM and truncation site runs.

Port of ``repro.core.policy`` for the modes the port has:

  fp32       — baseline, nothing inserted
  fp8        — raw e5m2 truncation around GEMMs (the diverging baseline):
               operands and output through ``fp8_truncate_bidir``
  s2fp8      — the paper's format
  s2fp8_e4m3 — the same on the e4m3 grid

and, for the s2fp8 modes, the reference's GEMM modes:

  payload — every GEMM runs payload-domain (``qdot_train``), attention
            runs as one payload flash node, and each result rounds to f32
            and then to the caller's dtype at the GEMM boundary
            (``_qdot_out``); a contraction the planner rejects raises
  fig4    — the paper's Fig. 4 chain: every operand and the output
            truncated (bidirectionally: the cotangents too) around an f32
            ``torch.matmul`` / ``torch.einsum``; attention takes the
            masked softmax with its two einsums through the chain
  auto    — as the reference resolves it: fig4 on the ``plain`` engine
            (the reference's ``ref``), payload on the kernel engines
            (``cuda`` and ``cuda_fused``, the reference's Pallas ones)

The f32 product of the chain runs as the reference's does outside any
kernel: ``torch.matmul`` in full f32 (PyTorch's default on CUDA, TF32 off;
the launchers print the setting), bf16 operands promoted to f32 as
``jnp.dot`` with ``preferred_element_type=f32`` promotes them.

Truncation sites (``truncate``, and the chain's operands and outputs)
follow the active StatsBank session (bank stats) or, outside one, exact
per-call stats through ``bidir_truncate``.  The bf16 and fp8_ls modes
(with the fp8_ls trainer's ``loss_scale``) come with later slices.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch.core import backend as nbackend
from repro_torch.core import qdot as qdot_mod
from repro_torch.core import s2fp8
from repro_torch.core import statsbank

MODES = ("fp32", "fp8", "s2fp8", "s2fp8_e4m3")
S2FP8_MODES = ("s2fp8", "s2fp8_e4m3")
# "auto": fig4 on the plain engine, payload on the kernel engines
GEMM_MODES = ("auto", "payload", "fig4")


@functools.lru_cache(maxsize=None)
def _s2fp8_wrap(backend: Optional[str], fmt: str) -> Callable:
    """Session-aware truncation of the s2fp8 modes (reference
    ``_s2fp8_wrap``): under a StatsBank session the site's stats (site
    kind ``t``), else exact per-call stats through ``bidir_truncate``."""
    exact = nbackend.bidir_truncate(backend, fmt)

    def wrap(x):
        sess = statsbank.current_session()
        if sess is not None:
            return sess.truncate(x, fmt=fmt, backend=backend)
        return exact(x)

    return wrap


@dataclasses.dataclass(frozen=True)
class Policy:
    mode: str = "fp32"                 # the reference's default
    backend: str = "auto"
    gemm_mode: str = "auto"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"numeric mode {self.mode!r} is not ported; "
                             f"want one of {MODES}")
        if self.backend != "auto" and self.backend not in nbackend.BACKENDS:
            raise ValueError(
                f"unknown numerics backend {self.backend!r}; want one of "
                f"{('auto',) + tuple(nbackend.BACKENDS)}")
        if self.gemm_mode not in GEMM_MODES:
            raise ValueError(f"gemm_mode {self.gemm_mode!r} is not ported; "
                             f"want one of {GEMM_MODES}")

    @property
    def backend_obj(self) -> nbackend.NumericsBackend:
        return nbackend.get_backend(self.backend)

    @property
    def _fmt(self) -> str:
        return "e4m3" if self.mode == "s2fp8_e4m3" else "e5m2"

    @property
    def accum_dtype(self):
        return torch.float32

    @property
    def uses_payload_gemm(self) -> bool:
        """Whether the s2fp8 GEMMs run payload-domain (``qdot_train``).
        "auto" resolves as the reference's (policy.py:158-171): payload on
        the kernel engines, fig4 on ``plain``."""
        if self.mode not in S2FP8_MODES:
            return False
        if self.gemm_mode != "auto":
            return self.gemm_mode == "payload"
        return isinstance(self.backend_obj, nbackend.CudaBackend)

    @property
    def _wrap(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """Operand / output truncation of the chain, and the truncation of
        every site, bidirectional, in the tensor's dtype."""
        if self.mode in S2FP8_MODES:
            return _s2fp8_wrap(self.backend, self._fmt)
        return s2fp8.fp8_truncate_bidir if self.mode == "fp8" else _identity

    def truncate(self, x: torch.Tensor) -> torch.Tensor:
        """Tensor-level truncation at op boundaries (site kind ``t``),
        bidirectional, in ``x``'s dtype."""
        return self._wrap(x)

    def _qdot_out(self, y: torch.Tensor, dtype) -> torch.Tensor:
        """Round the payload path's f32 result through ``accum_dtype`` to
        the caller's dtype (reference policy.py:191-197)."""
        return y.to(self.accum_dtype).to(dtype)

    def _dense(self, fn, *operands) -> torch.Tensor:
        """The chain of fp32, fp8 and fig4: truncated operands, an f32
        contraction, truncated output, the operands' promoted dtype."""
        y = fn(*[self._wrap(o).to(self.accum_dtype) for o in operands])
        return self._wrap(y).to(_promoted(operands))

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.uses_payload_gemm:
            y = qdot_mod.qdot_train(a, b, backend=self.backend, fmt=self._fmt)
            return self._qdot_out(y, torch.promote_types(a.dtype, b.dtype))
        return self._dense(torch.matmul, a, b)

    def dot_general(self, a: torch.Tensor, b: torch.Tensor,
                    dimension_numbers) -> torch.Tensor:
        """``lax.dot_general`` semantics (output ``batch + a_free +
        b_free``).  On the payload path every contraction the planner maps
        (``backend.plan_qdot_general``: dense, NT/TN, batched) runs
        payload-domain and the rest raise; fig4, fp32 and fp8 run the
        chain."""
        if self.uses_payload_gemm:
            plan = nbackend.plan_qdot_general(a.shape, b.shape,
                                              dimension_numbers)
            if plan is None:
                raise NotImplementedError(
                    f"no payload GEMM layout for {tuple(a.shape)} x "
                    f"{tuple(b.shape)} contracting {dimension_numbers}")
            y = qdot_mod.qdot_train(a, b, plan=plan, backend=self.backend,
                                    fmt=self._fmt)
            return self._qdot_out(y, torch.promote_types(a.dtype, b.dtype))
        spec = _dot_general_spec(a.dim(), b.dim(), dimension_numbers)
        return self._dense(lambda x, y: torch.einsum(spec, x, y), a, b)

    def einsum(self, spec: str, *operands) -> torch.Tensor:
        """Two-operand contractions the planner maps (``backend.
        plan_einsum``: dense, batched ``ecd,edf->ecf``, broadcast
        ``becd,edf->becf``, attention) run payload-domain on the payload
        path, and the others raise there; fig4, fp32 and fp8 run the
        chain, any contraction."""
        if self.uses_payload_gemm:
            plan = (nbackend.plan_einsum(spec, operands[0].shape,
                                         operands[1].shape)
                    if len(operands) == 2 else None)
            if plan is None:
                raise NotImplementedError(
                    f"no payload GEMM layout for einsum {spec!r} over "
                    f"{[tuple(o.shape) for o in operands]}")
            y = qdot_mod.qdot_train(*operands, plan=plan,
                                    backend=self.backend, fmt=self._fmt)
            return self._qdot_out(y, _promoted(operands))
        return self._dense(lambda *xs: torch.einsum(spec, *xs), *operands)

    def flash_attention(self, q, k, v, *, causal: bool = True,
                        window=None) -> torch.Tensor:
        """q ``[B, KV, G, Sq, d]``; k, v ``[B, KV, Sk, d]`` — the payload
        flash node (the payload path only)."""
        if not self.uses_payload_gemm:
            raise NotImplementedError(
                f"flash attention under mode {self.mode!r}, gemm_mode "
                f"{self.gemm_mode!r} is not ported; models take the "
                f"masked-softmax path")
        y = qdot_mod.qflash_attention(q, k, v, causal=causal, window=window,
                                      backend=self.backend, fmt=self._fmt)
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                 v.dtype)
        return self._qdot_out(y, dt)


def _identity(x):
    return x


def _promoted(operands) -> torch.dtype:
    """The contraction's result dtype: the operands' promoted dtype."""
    dtype = operands[0].dtype
    for o in operands[1:]:
        dtype = torch.promote_types(dtype, o.dtype)
    return dtype


def _dot_general_spec(a_rank: int, b_rank: int, dimension_numbers) -> str:
    """The einsum of a ``dot_general``: output ``batch + a_free +
    b_free``."""
    (ca, cb), (ba, bb) = dimension_numbers
    la = [chr(ord("a") + i) for i in range(a_rank)]
    lb = [chr(ord("a") + a_rank + i) for i in range(b_rank)]
    for i, j in list(zip(ca, cb)) + list(zip(ba, bb)):
        lb[j] = la[i]
    out = ([la[i] for i in ba]
           + [la[i] for i in range(a_rank) if i not in ca and i not in ba]
           + [lb[j] for j in range(b_rank) if j not in cb and j not in bb])
    return f"{''.join(la)},{''.join(lb)}->{''.join(out)}"


def make_policy(mode: str, backend: Optional[str] = None,
                gemm_mode: Optional[str] = None) -> Policy:
    return Policy(mode=mode, backend=backend or "auto",
                  gemm_mode=gemm_mode or "auto")
