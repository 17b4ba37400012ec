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
                      out_batch=None, tp=None, state="full"):
    """Sited payload GEMM: steady state is one launch with the Eq. 5
    epilogue on the carried stats; when the site is due, raw GEMM, refresh
    from the raw output, then truncate (refresh-then-use).  Under a model
    split (``tp``), ``state`` is the output's: a split output refreshes
    from the whole tensor's stats; a partial one runs the GEMM without its
    epilogue, all-reduces the f32 partials and truncates the sum (Eq. 5
    on a partial sum is another function)."""
    if state == "partial":
        y = _partial_sum(_qmm(be, qa, qb, layout, out_batch=out_batch,
                              fmt=fmt), tp)
        ab = (site.refresh(direction, y, fmt, backend)
              if site.need(direction) else site.carried(direction))
        return be.truncate(y, stats=ab, fmt=fmt)
    if site.need(direction):
        y_raw = _qmm(be, qa, qb, layout, out_batch=out_batch, fmt=fmt)
        ab = site.refresh(direction, y_raw, fmt, backend,
                          split=_split(tp, state))
        return be.truncate(y_raw, stats=ab, fmt=fmt)
    return _qmm(be, qa, qb, layout, out_batch=out_batch,
                epilogue_stats=site.carried(direction), fmt=fmt)


def _split(tp, state: str):
    """The mesh axis whose whole tensor a ``state`` tensor's stats take,
    or None (no model split, or a whole tensor)."""
    return None if tp is None else tp.split_axis(state)


def _partial_sum(y: torch.Tensor, tp) -> torch.Tensor:
    """The f32 partial sums of a split contraction, summed over the axis."""
    return collectives.all_reduce(y.float().contiguous(), tp.axis)


def _quant_exact(be, x, fmt, tp, state):
    """Payload of ``x`` under its exact stats: the engine's own reduction
    for a whole tensor (on ``cuda_fused`` the quantize-with-stats
    kernel), the whole tensor's for a split one."""
    axis = _split(tp, state)
    if axis is None:
        return be.quantize(x, fmt=fmt)
    return be.quantize(x, stats=nbackend.split_stats(be, x, fmt, axis),
                       fmt=fmt)


def _trunc_exact(be, y, fmt, tp, state):
    """Eq. 5 of a raw product under its exact stats (a partial product
    summed over the axis first)."""
    if state == "partial":
        y = _partial_sum(y, tp)
        state = "full"
    return be.truncate(y, stats=nbackend.split_stats(
        be, y, fmt, _split(tp, state)), fmt=fmt)


def _st(tp, which: str, grad: bool = False) -> str:
    """The state of operand / output ``which`` under ``tp`` (or of its
    cotangent): ``"full"`` without a split."""
    if tp is None:
        return "full"
    return tp.grad_state(which) if grad else tp.state(which)


def _ax(tp, which: str, grad: bool = False):
    """The split axis of ``which``'s (or its cotangent's) stats, or None."""
    return _split(tp, _st(tp, which, grad))


class _QdotBanked(torch.autograd.Function):
    """With ``fsdp`` (the quantized-FSDP handoff) ``b`` is the owner's
    dim-0 shard of the logical B: its ``b.fwd`` refresh all-reduces the
    partials over the session's ``axis_name`` (the shards partition the
    leaf, so the stats are the leaf-global ones and every owner quantizes
    on the same grid), the 1-byte payload all-gathers into the GEMM's B
    slot, and the backward reduce-scatters dB to the owner's shard."""

    @staticmethod
    def forward(ctx, a, b, site, be, backend, fmt, plan, fsdp=None,
                tp=None):
        qa = be.quantize(a, stats=site.stats(
            "a.fwd", a, fmt, backend, split=_ax(tp, "a")),
            fmt=fmt)
        qb = be.quantize(b, stats=site.stats(
            "b.fwd", b, fmt, backend, split=_ax(tp, "b")),
            fmt=fmt)
        if fsdp is not None:
            qb = collectives.payload_gather_axis(qb, fsdp.axis,
                                                 mesh=fsdp.mesh)
        y = _epilogue_qmatmul(be, qa, qb, plan.layout, site, "out.fwd", fmt,
                              backend, tp=tp, state=_st(tp, "out"))
        _save(ctx, qa, qb)
        ctx.meta = (site, be, backend, fmt, plan, a.dtype, b.dtype, fsdp,
                    tp)
        return y

    @staticmethod
    def backward(ctx, g):
        site, be, backend, fmt, plan, adt, bdt, fsdp, tp = ctx.meta
        (qa, qb), _ = _saved(ctx)
        qg = be.quantize(g, stats=site.stats(
            "out.bwd", g, fmt, backend, split=_ax(tp, "g")),
            fmt=fmt)
        ops = {"a": qa, "b": qb, "g": qg}
        _, (al, ar, alay, aob), (bl, br, blay, bob) = _gemm_structure(plan)
        da = _epilogue_qmatmul(be, ops[al], ops[ar], alay, site, "a.bwd",
                               fmt, backend, aob, tp, _st(tp, "a", True))
        db = _epilogue_qmatmul(be, ops[bl], ops[br], blay, site, "b.bwd",
                               fmt, backend, bob, tp, _st(tp, "b", True))
        if fsdp is not None:
            db = collectives.param_scatter_axis(db, fsdp)
        return (da.to(adt), db.to(bdt)) + (None,) * 7


class _QdotExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, be, fmt, plan, tp=None):
        qa = _quant_exact(be, a, fmt, tp, _st(tp, "a"))
        qb = _quant_exact(be, b, fmt, tp, _st(tp, "b"))
        y_raw = _qmm(be, qa, qb, plan.layout, fmt=fmt)
        _save(ctx, qa, qb)
        ctx.meta = (be, fmt, plan, a.dtype, b.dtype, tp)
        return _trunc_exact(be, y_raw, fmt, tp, _st(tp, "out"))

    @staticmethod
    def backward(ctx, g):
        be, fmt, plan, adt, bdt, tp = ctx.meta
        (qa, qb), _ = _saved(ctx)
        qg = _quant_exact(be, g, fmt, tp, _st(tp, "g"))
        ops = {"a": qa, "b": qb, "g": qg}
        grads = []
        for (lhs, rhs, lay, ob), which in zip(_gemm_structure(plan)[1:],
                                              "ab"):
            d = _qmm(be, ops[lhs], ops[rhs], lay, out_batch=ob, fmt=fmt)
            grads.append(_trunc_exact(be, d, fmt, tp, _st(tp, which, True)))
        return grads[0].to(adt), grads[1].to(bdt), None, None, None, None


def _qdot_frozen(be, fmt, a, b, site: statsbank.Site, layout: str,
                 tp=None):
    """Frozen-stats forward: zero stats reductions (a partial output is
    summed over the axis before its frozen truncation)."""
    qa = be.quantize(a, stats=site.frozen("a.fwd", fmt), fmt=fmt)
    qb = be.quantize(b, stats=site.frozen("b.fwd", fmt), fmt=fmt)
    if _st(tp, "out") == "partial":
        y = _partial_sum(_qmm(be, qa, qb, layout, fmt=fmt), tp)
        return be.truncate(y, stats=site.frozen("out.fwd", fmt), fmt=fmt)
    return _qmm(be, qa, qb, layout,
                epilogue_stats=site.frozen("out.fwd", fmt), fmt=fmt)


def qdot_train(a: torch.Tensor, b: torch.Tensor, *,
               plan: Optional[QdotPlan] = None,
               backend: Optional[str] = None, fmt: str = "e5m2",
               tp: Optional[collectives.TpSpec] = None) -> torch.Tensor:
    """Differentiable payload-domain contraction, one bank node (site kind
    ``qt``) of the active session, or exact stats outside one.  Without
    ``plan``: the dense ``[..., K] x [K, N] -> [..., N]`` family; with a
    :class:`QdotPlan` (``backend.plan_qdot_general`` or
    ``backend.plan_einsum``): its layout, reshapes and batch, broadcast
    operands included.  Returns f32 (the caller casts).

    ``b`` may be a :class:`collectives.FSDPPayloadParam` (the quantized-FSDP
    handoff, dense family only): it needs an active training session
    whose ``StatsConfig.axis_name`` covers the fsdp axis (the leaf-global
    stats contract), and raises elsewhere, as the reference does.

    ``tp`` (a :class:`collectives.TpSpec`): the contraction is the rank's
    part of one split over the model axis; every operand, output and
    cotangent that is split takes the whole tensor's stats, and a partial
    output (a split contracted dim) or cotangent is all-reduced in f32
    before its truncation.  ``b_pick`` is not taken here."""
    if tp is not None and tp.b_pick is not None:
        raise ValueError("qdot_train takes no b_pick: pick the operand "
                         "first")
    fsdp = None
    if isinstance(b, collectives.FSDPPayloadParam):
        if plan is not None:
            raise ValueError("FSDP payload operands support the dense "
                             "[..., K] x [K, N] family only (planned/"
                             "batched contractions coerce through the "
                             "f32 gather in Policy)")
        if tp is not None:
            raise ValueError("FSDP payload operands do not combine with a "
                             "model-axis split")
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
        y2 = _QdotExact.apply(a2, b2, be, fmt, plan, tp)
    elif sess.frozen:
        y2 = _qdot_frozen(be, fmt, a2, b2, sess.site("qt"), plan.layout, tp)
    else:
        y2 = _QdotBanked.apply(a2, b2, sess.site("qt"), be, backend, fmt,
                               plan, fsdp, tp)
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


def _pick(t: S2FP8Tensor, tp) -> S2FP8Tensor:
    """The K/V head ``tp.b_pick`` of a whole grouped payload [B, KV, S,
    d] (the stats are the whole tensor's)."""
    if tp is None or tp.b_pick is None:
        return t
    i = tp.b_pick
    return S2FP8Tensor(t.payload[:, i:i + 1].contiguous(), t.ab, t.fmt)


def _unpick(d: torch.Tensor, tp, kv: int) -> torch.Tensor:
    """A picked head's raw gradient placed in the whole K/V's (zeros
    elsewhere), before the all-reduce that sums the ranks' heads."""
    if tp is None or tp.b_pick is None:
        return d
    full = d.new_zeros((d.shape[0], kv) + tuple(d.shape[2:]))
    full[:, tp.b_pick:tp.b_pick + 1] = d
    return full


def _kv_grad(be, d, fmt, site, name, backend, tp, kv):
    """Eq. 5 of a raw K or V gradient: a whole K/V under split query heads
    holds a partial sum (summed over the axis first), a split one takes
    the whole tensor's stats; with a bank, the site's carried or
    refreshed stats, else exact ones."""
    state = _st(tp, "b", True)
    if state == "partial":
        d = _partial_sum(_unpick(d, tp, kv), tp)
        state = "full"
    if site is None:
        return _trunc_exact(be, d, fmt, tp, state)
    ab = site.stats(f"{name}.bwd", d, fmt, backend,
                    split=_split(tp, state))
    return be.truncate(d, stats=ab, fmt=fmt)


class _QflashBanked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, site, be, backend, fmt, causal, window, bq,
                bk, tp=None):
        qq = be.quantize(q, stats=site.stats(
            "q.fwd", q, fmt, backend, split=_ax(tp, "a")),
            fmt=fmt)
        kvs = _ax(tp, "b")
        qk = _pick(be.quantize(k, stats=site.stats(
            "k.fwd", k, fmt, backend, split=kvs), fmt=fmt), tp)
        qv = _pick(be.quantize(v, stats=site.stats(
            "v.fwd", v, fmt, backend, split=kvs), fmt=fmt), tp)
        if site.need("out.fwd"):
            raw, lse = _payload_flash_fwd(be, qq, qk, qv, causal, window,
                                          fmt, bq, bk, None)
            oab = site.refresh("out.fwd", raw, fmt, backend,
                               split=_ax(tp, "out"))
            out = be.truncate(raw, stats=oab, fmt=fmt)
        else:
            oab = site.carried("out.fwd")
            out, lse = _payload_flash_fwd(be, qq, qk, qv, causal, window,
                                          fmt, bq, bk, oab)
        # `out` is on the out site's grid, so this is its exact payload
        qo = be.quantize(out, stats=oab, fmt=fmt)
        _save(ctx, qq, qk, qv, qo, extra=(lse,))
        ctx.meta = (site, be, backend, fmt, causal, window, bq, bk,
                    (q.dtype, k.dtype, v.dtype), tp, k.shape[1])
        return out

    @staticmethod
    def backward(ctx, g):
        site, be, backend, fmt, causal, window, bq, bk, dts, tp, kv = \
            ctx.meta
        (qq, qk, qv, qo), (lse,) = _saved(ctx)
        g = g.float()
        qg = be.quantize(g, stats=site.stats(
            "out.bwd", g, fmt, backend, split=_ax(tp, "g")),
            fmt=fmt)
        dq, dk, dv = _payload_flash_bwd(be, qq, qk, qv, qg, lse,
                                        _flash_delta(be, qg, qo), causal,
                                        window, bq, bk)
        dq = be.truncate(dq, stats=site.stats(
            "q.bwd", dq, fmt, backend, split=_ax(tp, "a", True)),
            fmt=fmt)
        dk = _kv_grad(be, dk, fmt, site, "k", backend, tp, kv)
        dv = _kv_grad(be, dv, fmt, site, "v", backend, tp, kv)
        return (dq.to(dts[0]), dk.to(dts[1]), dv.to(dts[2])) + (None,) * 9


class _QflashExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, be, fmt, causal, window, bq, bk, tp=None):
        qq = _quant_exact(be, q, fmt, tp, _st(tp, "a"))
        qk = _pick(_quant_exact(be, k, fmt, tp, _st(tp, "b")), tp)
        qv = _pick(_quant_exact(be, v, fmt, tp, _st(tp, "b")), tp)
        raw, lse = _payload_flash_fwd(be, qq, qk, qv, causal, window, fmt,
                                      bq, bk, None)
        so = nbackend.split_stats(be, raw, fmt, _ax(tp, "out"))
        out = be.truncate(raw, stats=so, fmt=fmt)
        _save(ctx, qq, qk, qv, be.quantize(out, stats=so, fmt=fmt),
              extra=(lse,))
        ctx.meta = (be, fmt, causal, window, bq, bk,
                    (q.dtype, k.dtype, v.dtype), tp, k.shape[1])
        return out

    @staticmethod
    def backward(ctx, g):
        be, fmt, causal, window, bq, bk, dts, tp, kv = ctx.meta
        (qq, qk, qv, qo), (lse,) = _saved(ctx)
        g = g.float()
        qg = _quant_exact(be, g, fmt, tp, _st(tp, "g"))
        dq, dk, dv = _payload_flash_bwd(be, qq, qk, qv, qg, lse,
                                        _flash_delta(be, qg, qo), causal,
                                        window, bq, bk)
        dq = _trunc_exact(be, dq, fmt, tp, _st(tp, "a", True))
        dk = _kv_grad(be, dk, fmt, None, "k", None, tp, kv)
        dv = _kv_grad(be, dv, fmt, None, "v", None, tp, kv)
        return (dq.to(dts[0]), dk.to(dts[1]), dv.to(dts[2])) + (None,) * 7


def qflash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: Optional[int] = None,
                     backend: Optional[str] = None, fmt: str = "e5m2",
                     q_chunk: int = 512, kv_chunk: int = 512,
                     tp: Optional[collectives.TpSpec] = None
                     ) -> torch.Tensor:
    """Differentiable payload-domain flash attention, q ``[B, KV, G, Sq,
    d]``, k/v ``[B, KV, Sk, d]``; one bank node (site kind ``qf``) of the
    active session, or exact stats outside one.  Returns f32.

    ``tp``: the rank's query heads of an attention split over the model
    axis (``a`` q's state, ``b`` k/v's, ``out`` split): split tensors take
    the whole tensor's stats; K/V whole under split query heads (``b``
    "full", ``b_pick`` the K/V head the rank's queries use, q then [B, 1,
    G', Sq, d]) are quantized whole, and their gradients summed over the
    axis before truncation."""
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"qflash_attention wants q [B,KV,G,Sq,d], "
                         f"k/v [B,KV,Sk,d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    kv_used = k.shape[1] if tp is None or tp.b_pick is None else 1
    if (k.shape != v.shape or q.shape[0] != k.shape[0]
            or q.shape[1] != kv_used or q.shape[-1] != k.shape[-1]):
        raise ValueError(f"inconsistent attention shapes: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    window = None if window is None else int(window)
    be = nbackend.get_backend(backend)
    sess = statsbank.current_session()
    if sess is None or sess.discovery:
        if sess is not None:
            sess.site("qf")                  # record, then the exact path
        return _QflashExact.apply(q, k, v, be, fmt, causal, window, q_chunk,
                                  kv_chunk, tp)
    site = sess.site("qf")
    if sess.frozen:
        qq, qk, qv = (be.quantize(t, stats=site.frozen(f"{n}.fwd", fmt),
                                  fmt=fmt) for n, t in zip("qkv", (q, k, v)))
        out, _ = _payload_flash_fwd(be, qq, _pick(qk, tp), _pick(qv, tp),
                                    causal, window, fmt, q_chunk, kv_chunk,
                                    site.frozen("out.fwd", fmt))
        return out
    return _QflashBanked.apply(q, k, v, site, be, backend, fmt, causal,
                               window, q_chunk, kv_chunk, tp)
