"""Numeric policy of the port: the S2FP8 modes on the payload GEMM path.

Port of the serving part of ``repro.core.policy``.  Models call
``policy.dot`` / ``policy.truncate`` / ``policy.flash_attention`` and get
the paper's dataflow: every GEMM runs payload-domain (``qdot_train``),
attention runs as one payload flash node, and each result rounds to f32
and then to the caller's dtype at the GEMM boundary (``_qdot_out``).
The other modes (fp32, bf16, fp8, fp8_ls) and the fig4 GEMM mode come
with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import backend as nbackend
from repro_torch.core import qdot as qdot_mod
from repro_torch.core import statsbank

MODES = ("s2fp8", "s2fp8_e4m3")
# "auto" and "payload" both select the payload GEMM here; the composed
# fig4 chain is not ported.
GEMM_MODES = ("auto", "payload")


@dataclasses.dataclass(frozen=True)
class Policy:
    mode: str = "s2fp8"
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

    def truncate(self, x: torch.Tensor) -> torch.Tensor:
        """Bank-site Eq. 5 truncation (site kind ``t``) of the active
        session, in ``x``'s dtype."""
        sess = statsbank.current_session()
        if sess is None:
            raise ValueError("Policy.truncate runs inside a frozen or "
                             "calibrating StatsBank session in this port")
        return sess.truncate(x, fmt=self._fmt, backend=self.backend)

    def _qdot_out(self, y: torch.Tensor, dtype) -> torch.Tensor:
        """Round the payload path's f32 result through ``accum_dtype`` to
        the caller's dtype (reference policy.py:191-197)."""
        return y.to(self.accum_dtype).to(dtype)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        y = qdot_mod.qdot_train(a, b, backend=self.backend, fmt=self._fmt)
        return self._qdot_out(y, torch.promote_types(a.dtype, b.dtype))

    def flash_attention(self, q, k, v, *, causal: bool = True,
                        window=None) -> torch.Tensor:
        """q ``[B, KV, G, Sq, d]``; k, v ``[B, KV, Sk, d]``."""
        y = qdot_mod.qflash_attention(q, k, v, causal=causal, window=window,
                                      backend=self.backend, fmt=self._fmt)
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                 v.dtype)
        return self._qdot_out(y, dt)


def make_policy(mode: str, backend: Optional[str] = None,
                gemm_mode: Optional[str] = None) -> Policy:
    return Policy(mode=mode, backend=backend or "auto",
                  gemm_mode=gemm_mode or "auto")
