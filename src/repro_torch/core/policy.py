"""Numeric policy of the port: how every GEMM and truncation site runs.

Port of ``repro.core.policy``:

  fp32       — baseline, nothing inserted
  bf16       — operands cast to bf16, f32 accumulation, f32 result
  fp8        — raw e5m2 truncation around GEMMs (the diverging baseline):
               operands and output through ``fp8_truncate_bidir``
  fp8_ls     — the same truncations; the trainer scales the loss by
               ``loss_scale`` (paper Eq. 6)
  s2fp8      — the paper's format
  s2fp8_e4m3 — the same on the e4m3 grid

and, for the s2fp8 modes, the reference's GEMM modes:

  payload — a GEMM runs payload-domain (``qdot_train``) where the planner
            maps it, attention runs as one payload flash node, and each
            result rounds to f32 and then to the caller's dtype at the
            GEMM boundary (``_qdot_out``); a contraction the planner
            rejects, and a ``dot`` whose ``b`` is not 2-D, take the Fig. 4
            chain, as in the reference
  fig4    — the paper's Fig. 4 chain: every operand and the output
            truncated (bidirectionally: the cotangents too) around an f32
            product; attention takes the masked softmax with its two
            einsums through the chain (above 2048 tokens the chunked or
            the flash path, with the q/k/v/out sites truncated)
  auto    — as the reference resolves it: fig4 on the ``plain`` engine
            (the reference's ``ref``), payload on the kernel engines
            (``cuda`` and ``cuda_fused``, the reference's Pallas ones)

``truncate_output=False`` leaves the chain's output untruncated (refused
with ``gemm_mode="payload"``, whose kernels fuse that truncation);
``output_dtype="bfloat16"`` rounds each GEMM's f32 result to bf16 at the
GEMM boundary, on both GEMM paths.

The products of the chain run as the reference's do outside any kernel:
``torch.matmul`` / ``torch.einsum`` / ``torch.tensordot`` in full f32
(PyTorch's default on CUDA, TF32 off; the launchers print the setting) on
operands promoted to f32, as ``jnp.dot`` with ``preferred_element_type``
f32 promotes them.  The bf16 mode's product is that f32 product of the
exactly upcast bf16 operands: a bf16 x bf16 product has at most 16
significant bits, so every product is exact in f32 and only the order of
the f32 sums can differ from the reference's.  A cuBLAS bf16 GEMM would
round its result to bf16 (another function), and a bf16 GEMM with an f32
result needs an ``out_dtype`` argument that not every PyTorch release
has; the f32 product gives the reference's function on every build and on
the CPU.

Truncation sites (``truncate``, and the chain's operands and outputs)
follow the active StatsBank session (bank stats) or, outside one, exact
per-call stats through ``bidir_truncate``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch.core import backend as nbackend
from repro_torch.core import collectives as collectives_mod
from repro_torch.core import qdot as qdot_mod
from repro_torch.core import s2fp8
from repro_torch.core import statsbank

MODES = ("fp32", "bf16", "fp8", "fp8_ls", "s2fp8", "s2fp8_e4m3")
S2FP8_MODES = ("s2fp8", "s2fp8_e4m3")
# the modes whose GEMM outputs are truncated (with ``truncate_output``)
TRUNCATING_MODES = S2FP8_MODES + ("fp8", "fp8_ls")
# "auto": fig4 on the plain engine, payload on the kernel engines
GEMM_MODES = ("auto", "payload", "fig4")
OUTPUT_DTYPES = {None: torch.float32, "bfloat16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _s2fp8_wrap(backend: Optional[str], fmt: str,
                split: Optional[str] = None) -> Callable:
    """Session-aware truncation of the s2fp8 modes (reference
    ``_s2fp8_wrap``): under a StatsBank session the site's stats (site
    kind ``t``), else exact per-call stats through ``bidir_truncate``.
    ``split``: the tensor is the rank's slice of one split over that mesh
    axis, and its stats (forward and cotangent) are the whole tensor's."""
    exact = (nbackend.bidir_truncate(backend, fmt) if split is None
             else nbackend.bidir_truncate_split(backend, fmt, split))

    def wrap(x):
        sess = statsbank.current_session()
        if sess is not None:
            return sess.truncate(x, fmt=fmt, backend=backend, split=split)
        return exact(x)

    return wrap


def _bf16_cast(x):
    """bf16 operand storage; the product accumulates in f32."""
    return x.to(torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class Policy:
    mode: str = "fp32"                 # the reference's default
    truncate_output: bool = True       # truncate GEMM outputs too
    loss_scale: float = 1.0            # read by the trainer under fp8_ls
    output_dtype: Optional[str] = None  # None: f32; "bfloat16"
    backend: str = "auto"
    gemm_mode: str = "auto"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"numeric mode {self.mode!r} is not ported; "
                             f"want one of {MODES}")
        if self.backend != "auto" and \
                self.backend not in nbackend.available_backends():
            raise ValueError(
                f"unknown numerics backend {self.backend!r}; want one of "
                f"{('auto',) + nbackend.available_backends()}")
        if self.gemm_mode not in GEMM_MODES:
            raise ValueError(f"gemm_mode {self.gemm_mode!r} is not ported; "
                             f"want one of {GEMM_MODES}")
        if self.output_dtype not in OUTPUT_DTYPES:
            raise ValueError(f"output_dtype {self.output_dtype!r}; want one "
                             f"of {tuple(OUTPUT_DTYPES)}")
        if self.gemm_mode == "payload" and not self.truncate_output:
            # the payload kernels fuse the output truncation into the GEMM
            # epilogue, so they cannot leave the output untruncated
            raise ValueError(
                "gemm_mode='payload' requires truncate_output=True; "
                "use gemm_mode='auto' or 'fig4'")

    @property
    def backend_obj(self) -> nbackend.NumericsBackend:
        return nbackend.get_backend(self.backend)

    @property
    def _fmt(self) -> str:
        return "e4m3" if self.mode == "s2fp8_e4m3" else "e5m2"

    @property
    def accum_dtype(self):
        return OUTPUT_DTYPES[self.output_dtype]

    @property
    def uses_payload_gemm(self) -> bool:
        """Whether the s2fp8 GEMMs run payload-domain (``qdot_train``); never
        without ``truncate_output``.  "auto" resolves as the reference's
        (policy.py:158-171): payload on the kernel engines, fig4 on
        ``plain``."""
        if self.mode not in S2FP8_MODES or not self.truncate_output:
            return False
        if self.gemm_mode != "auto":
            return self.gemm_mode == "payload"
        return isinstance(self.backend_obj, nbackend.CudaBackend)

    def _qdot_routable(self, a: torch.Tensor, b: torch.Tensor) -> bool:
        return (self.uses_payload_gemm and b.dim() == 2 and a.dim() >= 1
                and a.shape[-1] == b.shape[0])

    @property
    def _wrap(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """Operand truncation of the chain, and the truncation of every
        site: bidirectional, in the tensor's dtype (bf16: the cast)."""
        if self.mode in S2FP8_MODES:
            return _s2fp8_wrap(self.backend, self._fmt)
        if self.mode in ("fp8", "fp8_ls"):
            return s2fp8.fp8_truncate_bidir
        if self.mode == "bf16":
            return _bf16_cast
        return _identity

    def _wrap_split(self, x: torch.Tensor, split: Optional[str]
                    ) -> torch.Tensor:
        """:meth:`_wrap` of a tensor split over the mesh axis ``split``
        (None: a whole one): the s2fp8 modes take the whole tensor's
        stats; the other modes' wraps are elementwise without stats."""
        if split is not None and self.mode in S2FP8_MODES:
            return _s2fp8_wrap(self.backend, self._fmt, split)(x)
        return self._wrap(x)

    def _wrap_out(self, y: torch.Tensor, split: Optional[str] = None
                  ) -> torch.Tensor:
        """The chain's output truncation: only under ``truncate_output``
        and only in the truncating modes (bf16 and fp32 keep the f32
        result)."""
        if self.truncate_output and self.mode in TRUNCATING_MODES:
            return self._wrap_split(y, split)
        return y

    def truncate(self, x: torch.Tensor, split: Optional[str] = None
                 ) -> torch.Tensor:
        """Tensor-level truncation at op boundaries (site kind ``t``),
        bidirectional, in ``x``'s dtype; ``split``: ``x`` is the rank's
        slice of a tensor split over that mesh axis (the whole tensor's
        stats).  An FSDP payload operand (``collectives.FSDPPayloadParam``)
        is not a GEMM B slot: it takes the f32 gather first."""
        if isinstance(x, collectives_mod.FSDPPayloadParam):
            x = x.full()
        return self._wrap_split(x, split)

    def _qdot_out(self, y: torch.Tensor, dtype) -> torch.Tensor:
        """Round the payload path's f32 result through ``accum_dtype`` to
        the caller's dtype (reference policy.py:191-197)."""
        return y.to(self.accum_dtype).to(dtype)

    def _dense(self, fn, *operands) -> torch.Tensor:
        """The chain: truncated operands, an f32 contraction rounded to
        ``accum_dtype``, the output truncation, the operands' promoted
        dtype.  With a bf16 ``accum_dtype`` the backward's contractions
        run as JAX transposes the reference's (``_NarrowAccum``)."""
        xs = [self._wrap(o).float() for o in operands]
        y = (fn(*xs) if self.accum_dtype == torch.float32
             else _NarrowAccum.apply(fn, self.accum_dtype, *xs))
        return self._wrap_out(y).to(_promoted(operands))

    def _dense_tp(self, fn, a, b, tp) -> torch.Tensor:
        """The chain of a contraction split over the model axis
        (``collectives.TpSpec``): split operands and outputs truncated with
        the whole tensor's stats; a whole operand beside a split output
        enters through ``copy_in`` after its truncation (its cotangent, a
        partial sum, is all-reduced before the truncation's backward), and
        ``b_pick`` takes its K/V head after that; a partial output is
        all-reduced in f32 before the output truncation."""
        wa = self._wrap_split(a, tp.split_axis(tp.a)).float()
        wb = self._wrap_split(b, tp.split_axis(tp.b)).float()
        if tp.out == "split":
            if tp.a == "full":
                wa = collectives_mod.copy_in(wa, tp.axis)
            if tp.b == "full":
                wb = collectives_mod.copy_in(wb, tp.axis)
        if tp.b_pick is not None:
            wb = wb[:, tp.b_pick:tp.b_pick + 1]
        if tp.out == "partial":
            y = collectives_mod.reduce_out(fn(wa, wb), tp.axis)
            y = y.to(self.accum_dtype)
        elif self.accum_dtype == torch.float32:
            y = fn(wa, wb)
        else:
            y = _NarrowAccum.apply(fn, self.accum_dtype, wa, wb)
        return self._wrap_out(y, tp.split_axis(tp.out)).to(
            _promoted((a, b)))

    def dot(self, a: torch.Tensor, b: torch.Tensor,
            tp: Optional[collectives_mod.TpSpec] = None) -> torch.Tensor:
        """``jnp.dot`` semantics (a's last axis against b's second to last,
        or b's only axis).  Payload-domain when ``b`` is a 2-D ``[K, N]``
        on the payload path, else the chain.  An FSDP payload operand
        streams into ``qdot_train`` as a gathered 1-byte payload where the
        payload path takes it, else it takes the f32 gather.  ``tp``: the
        rank's part of a contraction split over the model axis
        (``collectives.TpSpec``: column-parallel ``a`` whole, ``b`` and the
        output split; row-parallel ``a`` and ``b`` split, the output a
        partial sum)."""
        if tp is not None:
            if self._qdot_routable(a, b):
                y = qdot_mod.qdot_train(a, b, backend=self.backend,
                                        fmt=self._fmt, tp=tp)
                return self._qdot_out(y, torch.promote_types(a.dtype,
                                                             b.dtype))
            return self._dense_tp(_jnp_dot, a, b, tp)
        if isinstance(b, collectives_mod.FSDPPayloadParam):
            if self._qdot_routable(a, b):
                y = qdot_mod.qdot_train(a, b, backend=self.backend,
                                        fmt=self._fmt)
                return self._qdot_out(
                    y, torch.promote_types(a.dtype, b.dtype))
            b = b.full()
        if self._qdot_routable(a, b):
            y = qdot_mod.qdot_train(a, b, backend=self.backend, fmt=self._fmt)
            return self._qdot_out(y, torch.promote_types(a.dtype, b.dtype))
        return self._dense(_jnp_dot, a, b)

    def dot_general(self, a: torch.Tensor, b: torch.Tensor,
                    dimension_numbers,
                    tp: Optional[collectives_mod.TpSpec] = None
                    ) -> torch.Tensor:
        """``lax.dot_general`` semantics (output ``batch + a_free +
        b_free``).  On the payload path every contraction the planner maps
        (``backend.plan_qdot_general``: dense, NT/TN, batched) runs
        payload-domain; the rest, and fig4, fp32, bf16 and the fp8 modes,
        run the chain."""
        if isinstance(b, collectives_mod.FSDPPayloadParam):
            b = b.full()                # the f32 gather
        plan = (nbackend.plan_qdot_general(a.shape, b.shape,
                                           dimension_numbers)
                if self.uses_payload_gemm else None)
        if plan is not None:
            y = qdot_mod.qdot_train(a, b, plan=plan, backend=self.backend,
                                    fmt=self._fmt, tp=tp)
            return self._qdot_out(y, torch.promote_types(a.dtype, b.dtype))
        spec = _dot_general_spec(a.dim(), b.dim(), dimension_numbers)
        if tp is not None:
            return self._dense_tp(lambda x, y: torch.einsum(spec, x, y), a,
                                  b, tp)
        return self._dense(lambda x, y: torch.einsum(spec, x, y), a, b)

    def einsum(self, spec: str, *operands,
               tp: Optional[collectives_mod.TpSpec] = None) -> torch.Tensor:
        """Two-operand contractions the planner maps (``backend.
        plan_einsum``: dense, batched ``ecd,edf->ecf``, broadcast
        ``becd,edf->becf``, attention) run payload-domain on the payload
        path; every other contraction runs the chain.  ``tp`` as in
        :meth:`dot` (two operands)."""
        operands = tuple(o.full() if isinstance(
            o, collectives_mod.FSDPPayloadParam) else o for o in operands)
        if tp is not None:
            a, b = operands
            if self.uses_payload_gemm and tp.b_pick is None:
                plan = nbackend.plan_einsum(spec, a.shape, b.shape)
                if plan is not None:
                    y = qdot_mod.qdot_train(a, b, plan=plan,
                                            backend=self.backend,
                                            fmt=self._fmt, tp=tp)
                    return self._qdot_out(y, _promoted(operands))
            return self._dense_tp(lambda x, y: torch.einsum(spec, x, y), a,
                                  b, tp)
        if len(operands) == 2 and self.uses_payload_gemm:
            plan = nbackend.plan_einsum(spec, operands[0].shape,
                                        operands[1].shape)
            if plan is not None:
                y = qdot_mod.qdot_train(*operands, plan=plan,
                                        backend=self.backend, fmt=self._fmt)
                return self._qdot_out(y, _promoted(operands))
        return self._dense(lambda *xs: torch.einsum(spec, *xs), *operands)

    def conv(self, x: torch.Tensor, kernel: torch.Tensor, *,
             stride=(1, 1), padding="SAME") -> torch.Tensor:
        """NHWC x HWIO conv (the ResNet path; conv is a GEMM to the paper),
        ``padding`` "SAME", "VALID" or ((lo, hi), (lo, hi)) as
        ``lax.conv_general_dilated`` takes it ("SAME" pads asymmetrically
        at stride 2: 32 -> 16 with a 3x3 kernel pads (0, 1)).

        On the payload path the conv lowers to the payload GEMM through an
        im2col gather (:meth:`_conv_im2col`).  Every other mode wraps both
        operands, convolves the f32 upcasts (exact) in f32, rounds to
        ``accum_dtype`` (bf16 operands with a bf16 ``accum_dtype`` take the
        narrow transpose of ``_NarrowAccum``, as a bf16
        ``preferred_element_type`` does), applies the output truncation and
        returns x's dtype, as the reference does.  The convolution is
        ``F.conv2d`` over the explicitly padded input, the counterpart of
        the reference's ``lax.conv_general_dilated`` outside any kernel,
        forward and backward with cuDNN's TF32 off
        (``torch.backends.cudnn.allow_tf32`` is True by default, and a TF32
        conv computes another function than the f32 one)."""
        if self.uses_payload_gemm:
            return self._conv_im2col(x, kernel, stride, padding)
        pads = conv_pads(x.shape[1:3], kernel.shape[:2], stride, padding)
        wx, wk = self._wrap(x), self._wrap(kernel)
        op = torch.promote_types(wx.dtype, wk.dtype)
        fn = functools.partial(_conv_f32, stride=tuple(stride), pads=pads)
        xs = (wx.float(), wk.float())
        if (self.accum_dtype.itemsize < op.itemsize
                or self.accum_dtype == torch.float32):
            y = fn(*xs).to(self.accum_dtype)
        else:
            y = _NarrowAccum.apply(fn, self.accum_dtype, *xs)
        return self._wrap_out(y).to(x.dtype)

    def _conv_im2col(self, x, kernel, stride, padding) -> torch.Tensor:
        """Payload-domain conv: im2col gather -> dense payload GEMM.  The
        patches [B, OH, OW, KH*KW*C] are KH*KW strided slices of the
        zero-padded input concatenated with the (i, j) offset outer and the
        channel inner, which pairs them with ``kernel.reshape(KH*KW*C, F)``
        of the HWIO kernel (``F.unfold`` puts the channel outer).  Zero
        padding is exact for S2FP8: zeros are left out of the stats and
        quantize to zero payloads.  The GEMM is ``qdot_train``'s dense
        family, its backward the NT/TN payload GEMMs, scattered back
        through the slices by autograd.  The output shape is checked
        against the conv's."""
        kh, kw, cin, cout = kernel.shape
        sh, sw = stride
        patches = im2col(x, kh, kw, stride,
                         conv_pads(x.shape[1:3], (kh, kw), stride, padding))
        y = qdot_mod.qdot_train(patches, kernel.reshape(kh * kw * cin, cout),
                                backend=self.backend, fmt=self._fmt)
        expected = conv_out_shape(x.shape, kernel.shape, stride, padding)
        if tuple(y.shape) != expected:
            raise ValueError(
                f"im2col conv lowering produced {tuple(y.shape)}, but the "
                f"conv would produce {expected} (stride={stride}, "
                f"padding={padding!r})")
        return self._qdot_out(y, x.dtype)

    def flash_attention(self, q, k, v, *, causal: bool = True,
                        window=None,
                        tp: Optional[collectives_mod.TpSpec] = None
                        ) -> torch.Tensor:
        """q ``[B, KV, G, Sq, d]``; k, v ``[B, KV, Sk, d]``.  The payload
        path runs the payload flash node (``qdot.qflash_attention``: the
        flash kernels); every other policy truncates q, k and v at their
        sites, runs the chunked flash attention of ``models/flash.py``
        (plain torch, as the reference's is plain JAX) and truncates the
        output, so under a session it visits the chunked path's sites in
        the same order."""
        if self.uses_payload_gemm:
            y = qdot_mod.qflash_attention(q, k, v, causal=causal,
                                          window=window,
                                          backend=self.backend,
                                          fmt=self._fmt, tp=tp)
            dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                     v.dtype)
            return self._qdot_out(y, dt)
        from repro_torch.models.flash import flash_attention as _fa
        q, k, v = self.split_qkv(q, k, v, tp)
        window = None if window is None else int(window)
        return self.truncate(_fa(q, k, v, causal, window),
                             None if tp is None else tp.axis)

    def split_qkv(self, q, k, v, tp):
        """q, k and v truncated at their sites for an attention whose
        contractions run outside the policy (the flash and chunked
        paths): under a model split (``tp``), split tensors with the whole
        tensor's stats, and a whole K/V through ``copy_in`` (its cotangent
        summed over the axis) and ``b_pick``."""
        if tp is None:
            return self.truncate(q), self.truncate(k), self.truncate(v)
        kvs = tp.split_axis(tp.b)
        q = self.truncate(q, tp.split_axis(tp.a))
        k, v = self.truncate(k, kvs), self.truncate(v, kvs)
        if tp.b == "full":
            k = collectives_mod.copy_in(k, tp.axis)
            v = collectives_mod.copy_in(v, tp.axis)
        if tp.b_pick is not None:
            i = tp.b_pick
            k, v = k[:, i:i + 1], v[:, i:i + 1]
        return q, k, v

    def qdot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Forward-only payload GEMM of 2-D ``a [M, K]`` and ``b [K, N]``
        (reference policy.py:366-390): both operands quantized (the
        quantize kernels) and multiplied payload-domain (the payload GEMM
        kernel), no autograd node.  Under a session the operands take the
        read-only stats of their ``q`` sites (``Session.operand_stats``),
        else their exact stats.  Non-s2fp8 modes run ``dot``."""
        if self.mode not in S2FP8_MODES:
            return self.dot(a, b)
        fmt, be = self._fmt, self.backend_obj
        sess = statsbank.current_session()
        if sess is not None:
            sa = sess.operand_stats(a, fmt=fmt)
            sb = sess.operand_stats(b, fmt=fmt)
            y = be.qmatmul(be.quantize(a, stats=sa, fmt=fmt),
                           be.quantize(b, stats=sb, fmt=fmt))
        else:
            y = be.qmatmul(be.quantize(a, fmt=fmt), be.quantize(b, fmt=fmt))
        return self._wrap_out(y).to(a.dtype)


def _identity(x):
    return x


class _NarrowAccum(torch.autograd.Function):
    """``fn``'s f32 contraction rounded to ``dtype``.  Its backward is JAX's
    transpose of a dot with a narrow ``preferred_element_type``: each
    operand's gradient is the contraction of the cotangent with the other
    operands, all in ``dtype``, summed in f32 and rounded to ``dtype``."""

    @staticmethod
    def forward(ctx, fn, dtype, *xs):
        ctx.fn, ctx.dtype = fn, dtype
        ctx.save_for_backward(*xs)
        return fn(*xs).to(dtype)

    @staticmethod
    def backward(ctx, g):
        xs = ctx.saved_tensors
        narrow = [x.to(ctx.dtype).float().requires_grad_() for x in xs]
        with torch.enable_grad():
            y = ctx.fn(*narrow)
        grads = torch.autograd.grad(y, narrow, g.to(ctx.dtype).float())
        return (None, None) + tuple(d.to(ctx.dtype).to(x.dtype)
                                    for d, x in zip(grads, xs))


def _promoted(operands) -> torch.dtype:
    """The contraction's result dtype: the operands' promoted dtype."""
    dtype = operands[0].dtype
    for o in operands[1:]:
        dtype = torch.promote_types(dtype, o.dtype)
    return dtype


def _jnp_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.dot``: a's last axis against b's second to last (its only one
    when 1-D); ``torch.matmul`` would batch over b's leading axes
    instead."""
    if b.dim() <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 2]))


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


def conv_pads(spatial, window, stride, padding):
    """((lo, hi), (lo, hi)) of a conv's spatial padding, as
    ``lax.padtype_to_pads`` gives them: "SAME" pads to ceil(in / stride)
    outputs, the odd pad on the high side; "VALID" pads nothing; explicit
    pairs pass through."""
    if not isinstance(padding, str):
        return tuple((int(lo), int(hi)) for lo, hi in padding)
    if padding == "VALID":
        return tuple((0, 0) for _ in spatial)
    if padding != "SAME":
        raise ValueError(f"unknown padding {padding!r}")
    pads = []
    for n, k, s in zip(spatial, window, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def conv_out_shape(x_shape, k_shape, stride, padding):
    """The NHWC output shape of an NHWC x HWIO conv."""
    pads = conv_pads(x_shape[1:3], k_shape[:2], stride, padding)
    spatial = [(n + lo + hi - k) // s + 1 for n, k, s, (lo, hi)
               in zip(x_shape[1:3], k_shape[:2], stride, pads)]
    return (x_shape[0], *spatial, k_shape[3])


def im2col(x: torch.Tensor, kh: int, kw: int, stride, pads) -> torch.Tensor:
    """[B, OH, OW, KH*KW*C] patches of NHWC ``x``: the zero-padded input's
    KH*KW strided slices, (i, j) outer and the channel inner."""
    (pt, pb), (pl, pr) = pads
    sh, sw = stride
    xp = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb))
    oh = (xp.shape[1] - kh) // sh + 1
    ow = (xp.shape[2] - kw) // sw + 1
    cols = [xp[:, i:i + (oh - 1) * sh + 1:sh, j:j + (ow - 1) * sw + 1:sw]
            for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1)


@contextlib.contextmanager
def _cudnn_f32():
    """cuDNN convolutions in full f32: TF32 off while the block runs."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class _ConvF32(torch.autograd.Function):
    """``F.conv2d`` of NCHW x OIHW with TF32 off in the forward and in both
    backward convolutions."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with _cudnn_f32():
            return torch.nn.functional.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        grad = torch.nn.grad
        with _cudnn_f32():
            dx = grad.conv2d_input(x.shape, w, g, stride=ctx.stride)
            dw = grad.conv2d_weight(x, w.shape, g, stride=ctx.stride)
        return dx, dw, None


def _conv_f32(x: torch.Tensor, k: torch.Tensor, *, stride, pads
              ) -> torch.Tensor:
    """NHWC x HWIO -> NHWC in f32: the explicit pad, then the conv with no
    padding of its own."""
    (pt, pb), (pl, pr) = pads
    xp = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb))
    y = _ConvF32.apply(xp.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                       stride)
    return y.permute(0, 2, 3, 1)


def make_policy(mode: str, backend: Optional[str] = None,
                gemm_mode: Optional[str] = None, *,
                loss_scale: Optional[float] = None) -> Policy:
    """The port's positional order is ``(mode, backend, gemm_mode)``; the
    reference's is ``(mode, loss_scale, backend, gemm_mode)``.  Calls by
    keyword agree on both."""
    return Policy(mode=mode,
                  loss_scale=loss_scale if loss_scale is not None else 1.0,
                  backend=backend or "auto", gemm_mode=gemm_mode or "auto")
