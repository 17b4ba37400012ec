"""Payload-domain GEMM and flash-attention nodes (port of
``repro.core.qdot``).

Forward of a GEMM node::

    qA = quantize(A, a.fwd stats)    # 1 B/elt payloads
    qB = quantize(B, b.fwd stats)
    Y  = qmatmul(qA, qB, epilogue_stats=out.fwd stats)

Backward (paper Fig. 4's two transposed GEMMs, payload-domain)::

    qG = quantize(g, out.bwd stats)
    dA = qmatmul(qG, qB, layout="nt", epilogue_stats=a.bwd stats)
    dB = qmatmul(qA, qG, layout="tn", epilogue_stats=b.bwd stats)

for a forward layout "nn"; other forward layouts (the tied LM head's
``x . E^T`` is "nt") take their pair from ``_BWD_GEMMS``.  The residuals
saved for the backward are the 1-byte payloads plus their (alpha, beta):
no f32 operand is kept, and the backward reads them through the NT and TN
layouts, with no transposed copy.

Batched contractions (the MoE expert einsums) take the same nodes through
a :class:`QdotPlan` with ``batch > 1``: the operands reshape onto a
``(G, ., .)`` batched payload GEMM (``_qmm`` dispatches on rank), a
broadcast weight (``becd,edf``: ``Gb < G``) stays stored once, and its dW
sums the ``G // Gb`` broadcast groups inside the kernel (``out_batch``,
``_gemm_structure``).  The six StatsBank directions and the residuals do
not depend on the shape, so a batched node costs what a dense one does in
stats state.

The nodes, each a ``torch.autograd.Function`` where the reference has a
``jax.custom_vjp``:

  * ``_QdotBanked`` / ``_QflashBanked`` (reference ``_qdot_banked``,
    ``_qflash_banked``) — inside a training session: every operand, output
    and cotangent uses its site's carried stats; on a refresh step (or
    while the site is cold) the stats are refreshed from the tensor first
    (refresh-then-use).  A steady GEMM runs one launch with the fused Eq. 5
    epilogue; a refresh takes raw GEMM -> refresh -> truncate.  Refreshed
    states go to the session's ``updates``.  A calibrating session runs
    the same forward with every site refreshing.
  * ``_QdotExact`` / ``_QflashExact`` (``_qdot_exact``, ``_qflash_exact``)
    — outside any session (and during discovery): fresh exact stats per
    tensor, still payload-domain with payload residuals.  Their calls
    follow the reference's: each operand and cotangent is ``quantize``d
    without stats (the engine reduces them its own way: on ``cuda_fused``
    the quantize-with-stats kernel), each raw output gets
    ``compute_stats`` and then ``truncate`` with them.
  * frozen forwards (``_qdot_frozen``, ``_qflash_frozen``) — serving:
    frozen stats, no reductions, no autograd.

Gradients cross the bf16 casts as the reference's do: an operand passed in
bf16 gets its f32 gradient rounded to bf16.  Operands are quantized in the
dtype the caller passes: the reference casts them to f32 first, which is
exact, so the payloads are the same.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import backend as nbackend
from repro_torch.core import collectives, statsbank
from repro_torch.core.backend import QdotPlan
from repro_torch.core.s2fp8 import S2FP8Tensor
from repro_torch.kernels import flash_attention as _fkern

# Backward GEMM table: forward layout -> ((dA lhs, dA rhs, dA layout),
# (dB lhs, dB rhs, dB layout)) over the saved payloads "a", "b" and the
# quantized cotangent "g" (reference qdot.py:77-81).
_BWD_GEMMS = {
    "nn": (("g", "b", "nt"), ("a", "g", "tn")),
    "nt": (("g", "b", "nn"), ("g", "a", "tn")),
    "tn": (("b", "g", "nt"), ("a", "g", "nn")),
}


def _qmm(be, qx: S2FP8Tensor, qy: S2FP8Tensor, layout: str, *,
         out_batch: Optional[int] = None, epilogue_stats=None,
         fmt: str = "e5m2") -> torch.Tensor:
    """Rank dispatch (reference qdot.py:84-93): 2-D payloads -> ``qmatmul``,
    3-D -> the batched GEMM (``out_batch`` sums broadcast groups)."""
    if qx.payload.dim() == 2:
        return be.qmatmul(qx, qy, layout=layout,
                          epilogue_stats=epilogue_stats, fmt=fmt)
    return be.qmatmul_batched(qx, qy, layout=layout, out_batch=out_batch,
                              epilogue_stats=epilogue_stats, fmt=fmt)


def _gemm_structure(plan: QdotPlan):
    """(forward layout, dA spec, dB spec) of a plan (reference
    qdot.py:126-138).  Each backward spec is (lhs, rhs, layout,
    out_batch): out_batch sums the broadcast groups when the
    differentiated operand is stored broadcast (``Gb < G``)."""
    (da_l, da_r, da_lay), (db_l, db_r, db_lay) = _BWD_GEMMS[plan.layout]
    a_ob, b_ob = (None, None) if plan.batch == 1 else (plan.batch,
                                                       plan.b_batch)
    return (plan.layout, (da_l, da_r, da_lay, a_ob),
            (db_l, db_r, db_lay, b_ob))


def _save(ctx, *tensors: S2FP8Tensor, extra=()) -> None:
    """Residuals: each payload with its (alpha, beta), then ``extra``."""
    ctx.fmts = tuple(t.fmt for t in tensors)
    ctx.save_for_backward(*[x for t in tensors for x in (t.payload, t.ab)],
                          *extra)


def _saved(ctx):
    s = ctx.saved_tensors
    n = len(ctx.fmts)
    return ([S2FP8Tensor(s[2 * i], s[2 * i + 1], f)
             for i, f in enumerate(ctx.fmts)], s[2 * n:])


def _epilogue_qmatmul(be, qa, qb, layout, site, direction, fmt, backend,
                      out_batch=None):
    """Sited payload GEMM: steady state is one launch with the Eq. 5
    epilogue on the carried stats; when the site is due, raw GEMM, refresh
    from the raw output, then truncate (refresh-then-use)."""
    if site.need(direction):
        y_raw = _qmm(be, qa, qb, layout, out_batch=out_batch, fmt=fmt)
        ab = site.refresh(direction, y_raw, fmt, backend)
        return be.truncate(y_raw, stats=ab, fmt=fmt)
    return _qmm(be, qa, qb, layout, out_batch=out_batch,
                epilogue_stats=site.carried(direction), fmt=fmt)


class _QdotBanked(torch.autograd.Function):
    """With ``fsdp`` (the quantized-FSDP handoff) ``b`` is the owner's
    dim-0 shard of the logical B: its ``b.fwd`` refresh all-reduces the
    partials over the session's ``axis_name`` (the shards partition the
    leaf, so the stats are the leaf-global ones and every owner quantizes
    on the same grid), the 1-byte payload all-gathers into the GEMM's B
    slot, and the backward reduce-scatters dB to the owner's shard."""

    @staticmethod
    def forward(ctx, a, b, site, be, backend, fmt, plan, fsdp=None):
        qa = be.quantize(a, stats=site.stats("a.fwd", a, fmt, backend),
                         fmt=fmt)
        qb = be.quantize(b, stats=site.stats("b.fwd", b, fmt, backend),
                         fmt=fmt)
        if fsdp is not None:
            qb = collectives.payload_gather_axis(qb, fsdp.axis,
                                                 mesh=fsdp.mesh)
        y = _epilogue_qmatmul(be, qa, qb, plan.layout, site, "out.fwd", fmt,
                              backend)
        _save(ctx, qa, qb)
        ctx.meta = (site, be, backend, fmt, plan, a.dtype, b.dtype, fsdp)
        return y

    @staticmethod
    def backward(ctx, g):
        site, be, backend, fmt, plan, adt, bdt, fsdp = ctx.meta
        (qa, qb), _ = _saved(ctx)
        qg = be.quantize(g, stats=site.stats("out.bwd", g, fmt, backend),
                         fmt=fmt)
        ops = {"a": qa, "b": qb, "g": qg}
        _, (al, ar, alay, aob), (bl, br, blay, bob) = _gemm_structure(plan)
        da = _epilogue_qmatmul(be, ops[al], ops[ar], alay, site, "a.bwd",
                               fmt, backend, aob)
        db = _epilogue_qmatmul(be, ops[bl], ops[br], blay, site, "b.bwd",
                               fmt, backend, bob)
        if fsdp is not None:
            db = collectives.param_scatter_axis(db, fsdp)
        return da.to(adt), db.to(bdt), None, None, None, None, None, None


class _QdotExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, be, fmt, plan):
        qa = be.quantize(a, fmt=fmt)
        qb = be.quantize(b, fmt=fmt)
        y_raw = _qmm(be, qa, qb, plan.layout, fmt=fmt)
        _save(ctx, qa, qb)
        ctx.meta = (be, fmt, plan, a.dtype, b.dtype)
        return be.truncate(y_raw, stats=be.compute_stats(y_raw, fmt=fmt),
                           fmt=fmt)

    @staticmethod
    def backward(ctx, g):
        be, fmt, plan, adt, bdt = ctx.meta
        (qa, qb), _ = _saved(ctx)
        qg = be.quantize(g, fmt=fmt)
        ops = {"a": qa, "b": qb, "g": qg}
        grads = []
        for lhs, rhs, lay, ob in _gemm_structure(plan)[1:]:
            d = _qmm(be, ops[lhs], ops[rhs], lay, out_batch=ob, fmt=fmt)
            grads.append(be.truncate(d, stats=be.compute_stats(d, fmt=fmt),
                                     fmt=fmt))
        return grads[0].to(adt), grads[1].to(bdt), None, None, None


def _qdot_frozen(be, fmt, a, b, site: statsbank.Site, layout: str):
    """Frozen-stats forward: zero stats reductions."""
    qa = be.quantize(a, stats=site.frozen("a.fwd", fmt), fmt=fmt)
    qb = be.quantize(b, stats=site.frozen("b.fwd", fmt), fmt=fmt)
    return _qmm(be, qa, qb, layout,
                epilogue_stats=site.frozen("out.fwd", fmt), fmt=fmt)


def qdot_train(a: torch.Tensor, b: torch.Tensor, *,
               plan: Optional[QdotPlan] = None,
               backend: Optional[str] = None, fmt: str = "e5m2"
               ) -> torch.Tensor:
    """Differentiable payload-domain contraction, one bank node (site kind
    ``qt``) of the active session, or exact stats outside one.  Without
    ``plan``: the dense ``[..., K] x [K, N] -> [..., N]`` family; with a
    :class:`QdotPlan` (``backend.plan_qdot_general`` or
    ``backend.plan_einsum``): its layout, reshapes and batch, broadcast
    operands included.  Returns f32 (the caller casts).

    ``b`` may be a :class:`collectives.FSDPPayloadParam` (the quantized-FSDP
    handoff, dense family only): it needs an active training session
    whose ``StatsConfig.axis_name`` covers the fsdp axis (the leaf-global
    stats contract), and raises elsewhere, as the reference does."""
    fsdp = None
    if isinstance(b, collectives.FSDPPayloadParam):
        if plan is not None:
            raise ValueError("FSDP payload operands support the dense "
                             "[..., K] x [K, N] family only (planned/"
                             "batched contractions coerce through the "
                             "f32 gather in Policy)")
        fsdp = b.info
        b = b.shard
        k_full = b.shape[0] * fsdp.axis_size
        if b.dim() != 2 or a.dim() < 1 or a.shape[-1] != k_full:
            raise ValueError(f"qdot_train wants [..., K] x [K, N]; got "
                             f"{tuple(a.shape)} x FSDP shard "
                             f"{tuple(b.shape)} (full K = {k_full})")
        plan = QdotPlan("nn", (-1, a.shape[-1]), tuple(b.shape),
                        tuple(a.shape[:-1]) + (b.shape[-1],))
        sess = statsbank.current_session()
        if sess is None or sess.discovery:
            raise ValueError(
                "FSDP payload operands need an active StatsBank session "
                "(make_train_step(param_sharding='fsdp_q', stats=...)); "
                "discovery passes see full unwrapped params")
        if sess.frozen:
            raise ValueError("FSDP payload operands are a training-path "
                             "feature; frozen serving sessions see "
                             "replicated params")
        axes = sess.cfg.axis_name
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        if fsdp.axis not in axes:
            raise ValueError(
                f"fsdp_q needs leaf-global stats: StatsConfig.axis_name "
                f"{axes!r} must include the fsdp axis {fsdp.axis!r}")
    if plan is None:
        if b.dim() != 2 or a.dim() < 1 or a.shape[-1] != b.shape[0]:
            raise ValueError(f"qdot_train wants [..., K] x [K, N]; got "
                             f"{tuple(a.shape)} x {tuple(b.shape)}")
        plan = QdotPlan("nn", (-1, a.shape[-1]), tuple(b.shape),
                        tuple(a.shape[:-1]) + (b.shape[-1],))
    a2 = a.reshape(plan.a2_shape)
    b2 = b.reshape(plan.b2_shape)
    be = nbackend.get_backend(backend)
    sess = statsbank.current_session()
    if sess is None or sess.discovery:
        if sess is not None:
            sess.site("qt")                  # record, then the exact path
        y2 = _QdotExact.apply(a2, b2, be, fmt, plan)
    elif sess.frozen:
        y2 = _qdot_frozen(be, fmt, a2, b2, sess.site("qt"), plan.layout)
    else:
        y2 = _QdotBanked.apply(a2, b2, sess.site("qt"), be, backend, fmt,
                               plan, fsdp)
    return y2.reshape(plan.out_shape)


# ===========================================================================
# payload flash attention
# ===========================================================================

def _payload_flash_fwd(be, qq: S2FP8Tensor, qk: S2FP8Tensor, qv: S2FP8Tensor,
                       causal, window, fmt, bq, bk, out_stats):
    """Raw payload flash forward -> (out f32 [B,KV,G,Sq,d], lse
    [B,KV,G,Sq,1]).  ``cuda`` engine: the fused kernel (epilogue
    truncation in the kernel when ``out_stats`` is given).  ``plain``
    engine: dequantize + the grouped flash reference, then an elementwise
    truncate."""
    if isinstance(be, nbackend.CudaBackend):
        from repro_torch.kernels import dispatch
        return dispatch.qflash_fwd_grouped(
            qq, qk, qv, causal=causal, window=window,
            scale=1.0 / math.sqrt(qq.payload.shape[-1]), out_ab=out_stats,
            fmt=fmt)
    out, lse = _fkern.flash_fwd_reference(
        be.dequantize(qq), be.dequantize(qk), be.dequantize(qv),
        causal=causal, window=window, q_chunk=bq, kv_chunk=bk)
    if out_stats is not None:
        out = be.truncate(out, stats=out_stats, fmt=fmt)
    return out, lse


def _payload_flash_bwd(be, qq, qk, qv, qg, lse, delta, causal, window, bq,
                       bk):
    """Raw payload flash backward -> (dq, dk, dv) f32, grouped layout,
    score tiles recomputed from the payloads.  ``cuda``: the two-kernel
    schedule with the group sum outside; ``plain``: the recompute
    reference on dequantized payloads."""
    if isinstance(be, nbackend.CudaBackend):
        from repro_torch.kernels import dispatch
        return dispatch.qflash_bwd_grouped(
            qq, qk, qv, qg, lse, delta, causal=causal, window=window,
            scale=1.0 / math.sqrt(qq.payload.shape[-1]))
    return _fkern.flash_bwd_reference(
        be.dequantize(qq), be.dequantize(qk), be.dequantize(qv),
        be.dequantize(qg), lse, delta, causal=causal, window=window,
        q_chunk=bq, kv_chunk=bk)


def _flash_delta(be, qg: S2FP8Tensor, qo: S2FP8Tensor) -> torch.Tensor:
    """flash-2's rowwise D = sum(dout * out) on the dequantized payloads."""
    return (be.dequantize(qg) * be.dequantize(qo)).sum(dim=-1, keepdim=True)


class _QflashBanked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, site, be, backend, fmt, causal, window, bq,
                bk):
        qq = be.quantize(q, stats=site.stats("q.fwd", q, fmt, backend),
                         fmt=fmt)
        qk = be.quantize(k, stats=site.stats("k.fwd", k, fmt, backend),
                         fmt=fmt)
        qv = be.quantize(v, stats=site.stats("v.fwd", v, fmt, backend),
                         fmt=fmt)
        if site.need("out.fwd"):
            raw, lse = _payload_flash_fwd(be, qq, qk, qv, causal, window,
                                          fmt, bq, bk, None)
            oab = site.refresh("out.fwd", raw, fmt, backend)
            out = be.truncate(raw, stats=oab, fmt=fmt)
        else:
            oab = site.carried("out.fwd")
            out, lse = _payload_flash_fwd(be, qq, qk, qv, causal, window,
                                          fmt, bq, bk, oab)
        # `out` is on the out site's grid, so this is its exact payload
        qo = be.quantize(out, stats=oab, fmt=fmt)
        _save(ctx, qq, qk, qv, qo, extra=(lse,))
        ctx.meta = (site, be, backend, fmt, causal, window, bq, bk,
                    (q.dtype, k.dtype, v.dtype))
        return out

    @staticmethod
    def backward(ctx, g):
        site, be, backend, fmt, causal, window, bq, bk, dts = ctx.meta
        (qq, qk, qv, qo), (lse,) = _saved(ctx)
        g = g.float()
        qg = be.quantize(g, stats=site.stats("out.bwd", g, fmt, backend),
                         fmt=fmt)
        raws = _payload_flash_bwd(be, qq, qk, qv, qg, lse,
                                  _flash_delta(be, qg, qo), causal, window,
                                  bq, bk)
        grads = [be.truncate(d, stats=site.stats(f"{n}.bwd", d, fmt,
                                                 backend), fmt=fmt).to(dt)
                 for n, d, dt in zip("qkv", raws, dts)]
        return (*grads,) + (None,) * 8


class _QflashExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, be, fmt, causal, window, bq, bk):
        qq, qk, qv = (be.quantize(t, fmt=fmt) for t in (q, k, v))
        raw, lse = _payload_flash_fwd(be, qq, qk, qv, causal, window, fmt,
                                      bq, bk, None)
        so = be.compute_stats(raw, fmt=fmt)
        out = be.truncate(raw, stats=so, fmt=fmt)
        _save(ctx, qq, qk, qv, be.quantize(out, stats=so, fmt=fmt),
              extra=(lse,))
        ctx.meta = (be, fmt, causal, window, bq, bk,
                    (q.dtype, k.dtype, v.dtype))
        return out

    @staticmethod
    def backward(ctx, g):
        be, fmt, causal, window, bq, bk, dts = ctx.meta
        (qq, qk, qv, qo), (lse,) = _saved(ctx)
        g = g.float()
        qg = be.quantize(g, fmt=fmt)
        raws = _payload_flash_bwd(be, qq, qk, qv, qg, lse,
                                  _flash_delta(be, qg, qo), causal, window,
                                  bq, bk)
        grads = [be.truncate(d, stats=be.compute_stats(d, fmt=fmt),
                             fmt=fmt).to(dt) for d, dt in zip(raws, dts)]
        return (*grads,) + (None,) * 6


def qflash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: Optional[int] = None,
                     backend: Optional[str] = None, fmt: str = "e5m2",
                     q_chunk: int = 512, kv_chunk: int = 512
                     ) -> torch.Tensor:
    """Differentiable payload-domain flash attention, q ``[B, KV, G, Sq,
    d]``, k/v ``[B, KV, Sk, d]``; one bank node (site kind ``qf``) of the
    active session, or exact stats outside one.  Returns f32."""
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"qflash_attention wants q [B,KV,G,Sq,d], "
                         f"k/v [B,KV,Sk,d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if (k.shape != v.shape or q.shape[:2] != k.shape[:2]
            or q.shape[-1] != k.shape[-1]):
        raise ValueError(f"inconsistent attention shapes: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    window = None if window is None else int(window)
    be = nbackend.get_backend(backend)
    sess = statsbank.current_session()
    if sess is None or sess.discovery:
        if sess is not None:
            sess.site("qf")                  # record, then the exact path
        return _QflashExact.apply(q, k, v, be, fmt, causal, window, q_chunk,
                                  kv_chunk)
    site = sess.site("qf")
    if sess.frozen:
        qq, qk, qv = (be.quantize(t, stats=site.frozen(f"{n}.fwd", fmt),
                                  fmt=fmt) for n, t in zip("qkv", (q, k, v)))
        out, _ = _payload_flash_fwd(be, qq, qk, qv, causal, window, fmt,
                                    q_chunk, kv_chunk,
                                    site.frozen("out.fwd", fmt))
        return out
    return _QflashBanked.apply(q, k, v, site, be, backend, fmt, causal,
                               window, q_chunk, kv_chunk)
