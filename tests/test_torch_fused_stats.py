"""The port's fused-stats engine (``cuda_fused``) against the JAX package,
on the CPU.

The three stats kernels of ``repro_torch.kernels.s2fp8_quant`` —
``stats_partials``, ``quant`` and ``truncate_fused`` — take their plain
versions on a CPU tensor; these are held against the JAX kernels they
replace (``stats_pallas``, ``quant_pallas``, ``truncate_fused_pallas``)
run in interpret mode, on the same numpy inputs, small and ragged, f32
and bf16, at scales 1e-7, 1 and 1e6.  Then the engines: ``cuda_fused``
against the JAX ``pallas_fused`` engine; ``plain`` and ``cuda`` unchanged
by ``stats=None``; the reduction counter; and a 24-step curve of the
reduced minicpm with exact stats on ``cuda_fused`` against the JAX ``ref``
engine.

Tolerances, the reference's own (``tests/test_kernels.py``,
``tests/test_backend_dispatch.py``), split where the two sides' stats
differ.  Torch's log2 and XLA's (``log * 1/ln2``) differ in the last ulp,
and the reference sums log2|x| in f32 blocks where the port sums in f64:
the nonzero count is exact, the max within 1e-6 relative, the sum within
1e-5 of a numpy f64 sum; alpha within 1e-4 relative, beta within 1e-4
relative + 1e-3.  Payloads: with the reference kernel's (alpha, beta)
given to the port's map, at least 99.8% equal (measured: all equal);
each side with its own stats, at least 99.7% — the reference's f32 sums
put its alpha up to 3e-6 relative off at |log2 x| near 20, and bf16
inputs on the e4m3 grid then cross rounding boundaries together
(measured: up to 0.22% of the payloads, 74 of 33,153).  Truncated values:
zero sets agree in over 99.5% of the elements; on the common nonzeros at
least 99.8% within 1e-3 relative (measured: up to 0.15% flipped, also
with shared stats, where XLA's folded log2/exp2 move a code), and every
one within 0.1 relative (one code step is about 5%).  A bf16 input is
compared through its f32 values: the port's bf16 result is exactly its
f32 result rounded to bf16, as the reference's dispatch casts it.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_reduced_config as jax_reduced_config
from repro.core import backend as jbackend
from repro.core.policy import make_policy as jax_policy
from repro.kernels import dispatch as jdispatch
from repro.kernels.s2fp8_quant import truncate_fused_pallas
from repro.models import transformer as jtlm
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.training.trainer import make_train_step as jax_train_step
from repro_torch import kernels
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core import backend as tbackend
from repro_torch.core import qdot as tqdot
from repro_torch.core import s2fp8 as ts2fp8
from repro_torch.core import statsbank as tsb
from repro_torch.core.policy import make_policy
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import s2fp8_quant
from repro_torch.models import transformer as tlm
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.training import trainer as ttrainer

jax.config.update("jax_platform_name", "cpu")

# a block-aligned, a ragged and a 3-D shape, each of at least 8192
# elements as the reference's: the payload criterion is a rate
CASES = [(shape, scale) for shape in [(64, 128), (129, 257), (5, 33, 65)]
         for scale in (1e-7, 1.0, 1e6)]
DTYPES = ["float32", "bfloat16"]


def _inputs(shape, scale, dtype, seed=0):
    """The same values as a torch tensor (of ``dtype``), a JAX f32 array
    and numpy f32: bf16 inputs are rounded once, by torch, and both sides
    read those values."""
    x = (np.random.default_rng(seed).standard_normal(shape)
         * scale).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    xf = tx.float().numpy()
    return tx, jnp.asarray(xf), xf


def _check_stats(alpha, beta, ja, jb):
    np.testing.assert_allclose(float(alpha), float(ja), rtol=1e-4)
    np.testing.assert_allclose(float(beta), float(jb), rtol=1e-4, atol=1e-3)


def _check_truncated(o, r):
    o, r = np.asarray(o, np.float32), np.asarray(r, np.float32)
    assert ((o == 0) == (r == 0)).mean() > 0.995
    nz = (o != 0) & (r != 0)
    rel = np.abs(o[nz] - r[nz]) / np.abs(r[nz])
    assert (rel <= 1e-3).mean() >= 0.998 and rel.max() <= 0.1, \
        ((rel > 1e-3).sum(), rel.max())


@pytest.fixture
def counted():
    kernels.reset_counts()
    yield kernels.counts
    kernels.reset_counts()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,scale", CASES)
def test_stats_plain_matches_stats_pallas(shape, scale, dtype, counted):
    tx, jx, xf = _inputs(shape, scale, dtype)
    triplet, ab = s2fp8_quant.stats_partials(tx)
    assert counted()["stats"] == {"launches": 0, "plain_calls": 1}
    js, jm, jc = jdispatch.stats_partials_nd(jx, interpret=True)
    absx = np.abs(xf.astype(np.float64))
    nz = absx > 0
    assert float(triplet[2]) == float(jc) == nz.sum()
    np.testing.assert_allclose(float(triplet[1]), float(jm), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(triplet[0]), np.log2(absx[nz]).sum(),
                               rtol=1e-5)
    # (alpha, beta) are the format's map of the triplet
    a, b = ts2fp8.stats_from_reduction(triplet[0], triplet[1], triplet[2])
    assert torch.equal(ab, torch.stack([a, b]))


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,scale", CASES)
def test_quant_plain_matches_quant_pallas(shape, scale, dtype, fmt, counted):
    tx, jx, _ = _inputs(shape, scale, dtype, seed=1)
    payload, ab = s2fp8_quant.quant(tx, fmt)
    assert counted()["quant"] == {"launches": 0, "plain_calls": 1}
    assert payload.shape == tx.shape
    assert payload.dtype == ts2fp8.FMT_QDTYPE[fmt]
    jp, ja, jb = jdispatch.quant_nd(jx, fmt=fmt, interpret=True)
    _check_stats(ab[0], ab[1], ja, jb)
    pr = np.asarray(jp.astype(jnp.float32))
    shared = s2fp8_quant.quant_apply(tx, (float(ja), float(jb)), fmt)
    assert (shared.float().numpy() == pr).mean() >= 0.998
    assert (payload.float().numpy() == pr).mean() >= 0.997


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,scale", CASES)
def test_truncate_fused_plain_matches_truncate_fused_pallas(
        shape, scale, dtype, fmt, counted):
    tx, jx, _ = _inputs(shape, scale, dtype, seed=2)
    out, ab = s2fp8_quant.truncate_fused(tx, fmt)
    assert counted()["truncate_fused"] == {"launches": 0, "plain_calls": 1}
    assert out.dtype == tx.dtype and out.shape == tx.shape
    out32, ab32 = s2fp8_quant.truncate_fused(tx.float(), fmt)
    assert torch.equal(ab, ab32)
    assert torch.equal(out, out32.to(tx.dtype))
    x2 = jdispatch.as_blocked_2d(jx)
    jo2, ja, jb = truncate_fused_pallas(
        x2, fmt=fmt, target_max=ts2fp8.FMT_TARGET_MAX[fmt], interpret=True)
    _check_stats(ab[0], ab[1], ja, jb)
    _check_truncated(out32.numpy(), jdispatch.from_blocked_2d(jo2, jx.shape))


def test_degenerate_inputs():
    """All-zero: identity stats (1, 0) and zeros back; a constant 2.75
    comes back at 2.75 within 1e-2; NaNs are left out of the stats, as in
    the reference kernel."""
    z = torch.zeros(64, 64)
    triplet, ab = s2fp8_quant.stats_partials(z)
    assert triplet.tolist() == [0.0, -math.inf, 0.0]
    assert ab.tolist() == [1.0, 0.0]
    payload, ab = s2fp8_quant.quant(z)
    assert ab.tolist() == [1.0, 0.0] and not payload.float().any()
    out, ab = s2fp8_quant.truncate_fused(z)
    assert ab.tolist() == [1.0, 0.0] and not out.any()
    _, ja, jb = truncate_fused_pallas(jnp.zeros((64, 64)), interpret=True)
    assert (float(ja), float(jb)) == (1.0, 0.0)

    c = torch.full((64, 64), 2.75)
    out, _ = s2fp8_quant.truncate_fused(c)
    np.testing.assert_allclose(out.numpy(), 2.75, rtol=1e-2)

    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (32, 48)).astype(np.float32))
    xn = x.clone()
    xn[::5, ::7] = math.nan
    xz = torch.nan_to_num(xn, nan=0.0)
    tn, abn = s2fp8_quant.stats_partials(xn)
    tz, abz = s2fp8_quant.stats_partials(xz)
    assert torch.equal(tn, tz) and torch.equal(abn, abz)
    assert float(tn[2]) == int((xz != 0).sum())
    js, jm, jc = jdispatch.stats_partials_nd(jnp.asarray(xn.numpy()),
                                             interpret=True)
    assert float(jc) == float(tn[2])
    np.testing.assert_allclose(float(js), float(tn[0]), rtol=1e-5)


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_cuda_fused_engine_matches_pallas_fused(fmt):
    """``cuda_fused`` (plain versions on the CPU) against the JAX
    ``pallas_fused`` engine (interpret mode): ``compute_stats``,
    ``compute_stats_partials``, ``quantize(x)`` and ``truncate(x)``."""
    tx, jx, xf = _inputs((48, 80), 1e3, "float32", seed=4)
    te, je = tbackend.get_backend("cuda_fused"), jbackend.get_backend(
        "pallas_fused")
    assert te.name == "cuda_fused" and te.stats_mode == "fused"
    assert isinstance(te, tbackend.CudaBackend)

    ts, tm, tc = te.compute_stats_partials(tx)
    js, jm, jc = je.compute_stats_partials(jx)
    assert float(tc) == float(jc)
    np.testing.assert_allclose(float(tm), float(jm), rtol=1e-6)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)

    ab = te.compute_stats(tx, fmt=fmt)
    _check_stats(ab[0], ab[1], *je.compute_stats(jx, fmt=fmt))

    tq, jq = te.quantize(tx, fmt=fmt), je.quantize(jx, fmt=fmt)
    assert torch.equal(tq.ab, ab)
    _check_stats(tq.alpha, tq.beta, jq.alpha, jq.beta)
    assert (tq.payload.float().numpy()
            == np.asarray(jq.payload.astype(jnp.float32))).mean() >= 0.997

    _check_truncated(te.truncate(tx, fmt=fmt).numpy(),
                     je.truncate(jx, fmt=fmt))


@pytest.mark.parametrize("engine", ["plain", "cuda"])
def test_exact_engines_unchanged_by_stats_none(engine):
    """On ``plain`` and ``cuda``, ``quantize(x)`` / ``truncate(x)`` without
    stats are bit for bit the calls with ``stats=compute_stats(x)`` (what
    the nodes and ``bidir_truncate`` passed before), whose stats are the
    torch reduction's; and the exact GEMM node gives the same bits as that
    explicit composition, forward and backward."""
    be = tbackend.get_backend(engine)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((40, 56)).astype(np.float32))
    for fmt in ("e5m2", "e4m3"):
        ab = be.compute_stats(x, fmt=fmt)
        assert torch.equal(ab, ts2fp8.compute_stats(
            x, ts2fp8.FMT_TARGET_MAX[fmt]))
        q0, q1 = be.quantize(x, stats=ab, fmt=fmt), be.quantize(x, fmt=fmt)
        assert torch.equal(q1.ab, q0.ab)
        assert torch.equal(q1.payload.view(torch.uint8),
                           q0.payload.view(torch.uint8))
        assert torch.equal(be.truncate(x, fmt=fmt),
                           be.truncate(x, stats=ab, fmt=fmt))
        xb = x.to(torch.bfloat16)
        assert torch.equal(tbackend.bidir_truncate(engine, fmt)(xb),
                           be.truncate(xb, stats=be.compute_stats(
                               xb, fmt=fmt), fmt=fmt))

    a = torch.from_numpy(rng.standard_normal((24, 40)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((40, 16)) / 6.3).astype(
        np.float32))
    g = torch.from_numpy((rng.standard_normal((24, 16)) * 1e-3).astype(
        np.float32))

    def exact(t):
        return be.quantize(t, stats=be.compute_stats(t))

    def trunc(t):
        return be.truncate(t, stats=be.compute_stats(t))

    qa, qb, qg = exact(a), exact(b), exact(g)
    want_y = trunc(tqdot._qmm(be, qa, qb, "nn"))
    want_da = trunc(tqdot._qmm(be, qg, qb, "nt"))
    want_db = trunc(tqdot._qmm(be, qa, qg, "tn"))
    ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
    y = tqdot.qdot_train(ta, tb, backend=engine)
    y.backward(g)
    assert torch.equal(y, want_y)
    assert torch.equal(ta.grad, want_da) and torch.equal(tb.grad, want_db)


def _tiny_lm():
    cfg = get_reduced_config("minicpm_2b").replace(
        n_layers=2, remat=False, vocab=64, d_model=32, n_heads=2,
        kv_heads=2, head_dim=16, d_ff=64)

    def loss_fn(p, b, pol_):
        return tlm.loss_fn(p, b["tokens"], b["labels"], cfg, pol_)

    chain = tsyn.markov_chain(0, cfg.vocab)
    gen = torch.Generator().manual_seed(0)
    batches = [tsyn.lm_batch(chain, gen, 2, 16, "cpu") for _ in range(3)]
    return cfg, loss_fn, batches


def test_count_reductions_steady_bank_step_counts_as_fp32():
    """The counterpart of the reference's jaxpr count: a steady banked step
    runs as many whole-tensor reductions as the fp32 step (the refresh is
    decided on the host, so no bookkeeping reduction either), a refresh
    step and an exact-stats step run more (three per stats reduction)."""
    cfg, loss_fn, batches = _tiny_lm()

    def counts(mode, refresh_every):
        pol = make_policy(mode, "plain", "payload")
        params = tlm.init_lm(cfg, seed=0, device="cpu")
        opt = topt.adamw()
        state = opt.init(params)
        stats = (tsb.StatsConfig(refresh_every=refresh_every)
                 if refresh_every else None)
        step = ttrainer.make_train_step(loss_fn, opt, tsched.constant(1e-3),
                                        pol, stats=stats)
        bank = (tsb.init_bank(loss_fn, params, batches[0], pol, stats)
                if stats else None)
        out = []
        for s in range(2):
            with tsb.count_reductions() as c:
                if bank is None:
                    params, state, _ = step(params, state, batches[s], s)
                else:
                    params, state, bank, _ = step(params, state, bank,
                                                  batches[s], s)
            out.append(c.n)
            assert sum(c.by_op.values()) >= c.n
        return out

    fp32 = counts("fp32", 0)
    refresh, steady = counts("s2fp8", 2)
    exact = counts("s2fp8", 0)
    assert fp32[0] == fp32[1] > 0
    assert steady == fp32[0]
    assert refresh > steady and exact[0] == exact[1] > steady
    assert (exact[0] - steady) % 3 == 0      # (sum, max, count) per stats


def test_count_reductions_skips_elementwise_max():
    x = torch.arange(6.0).reshape(2, 3)
    with tsb.count_reductions() as c:
        torch.maximum(x, x)
        torch.max(x, x)
        x.max()
        x.sum(dim=0)
    assert c.n == 1
    assert sum(c.by_op.values()) == 2


# ---------------------------------------------------------------------------
# a curve: exact stats on cuda_fused, payload GEMMs, against the JAX ref
# ---------------------------------------------------------------------------

STEPS = 24
JCFG = jax_reduced_config("minicpm_2b").replace(n_layers=2, remat=False,
                                                vocab=64)
TCFG = get_reduced_config("minicpm_2b").replace(n_layers=2, remat=False,
                                                vocab=64)


def test_cuda_fused_payload_curve_tracks_jax_ref_engine():
    """Reduced minicpm (``tests/test_torch_train.py``'s quickstart set-up),
    24 AdamW steps of s2fp8 with exact per-call stats: the port's
    ``cuda_fused`` engine (every stats reduction through the stats
    kernels' plain versions) against the JAX ``ref`` engine, both on the
    payload GEMMs; the bounds of that file's s2fp8 run (largest |loss
    difference| 0.05, mean 0.02)."""
    chain = tsyn.markov_chain(0, TCFG.vocab)
    gen = torch.Generator().manual_seed(0)
    tb = [tsyn.lm_batch(chain, gen, 8, 64, "cpu") for _ in range(STEPS)]
    batches = [{k: v.numpy().astype(np.int32) for k, v in b.items()}
               for b in tb]
    params0 = jtlm.init_lm(JCFG, jax.random.PRNGKey(0))

    def jloss(p, b, pol):
        return jtlm.loss_fn(p, b["tokens"], b["labels"], JCFG, pol)

    def tloss(p, b, pol):
        return tlm.loss_fn(p, b["tokens"], b["labels"], TCFG, pol)

    opt = jopt.adamw()
    step = jax.jit(jax_train_step(jloss, opt, jsched.constant(3e-3),
                                  jax_policy("s2fp8", backend="ref",
                                             gemm_mode="payload")))
    params, state, jl = params0, opt.init(params0), []
    for s in range(STEPS):
        params, state, m = step(params, state, batches[s], jnp.int32(s))
        jl.append(float(m["loss"]))

    kernels.reset_counts()
    topt_ = topt.adamw()
    params = params_from_jax(jax.device_get(params0), device="cpu")
    state = topt_.init(params)
    tstep = ttrainer.make_train_step(tloss, topt_, tsched.constant(3e-3),
                                     make_policy("s2fp8", "cuda_fused"))
    tl = []
    for s in range(STEPS):
        params, state, m = tstep(params, state, tb[s], s)
        tl.append(float(m["loss"]))
    used = kernels.counts()
    assert all(used[k]["plain_calls"] > 0 for k in ("stats", "quant",
                                                    "truncate_fused"))
    d = np.abs(np.array(jl) - np.array(tl))
    assert np.all(np.isfinite(tl))
    assert d.max() <= 0.05 and d.mean() <= 0.02, (d.max(), d.mean())
