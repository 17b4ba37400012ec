"""The port's numeric modes and policy options against the JAX package's
policy, on the CPU.

Each op (``dot`` with a 2-D and a 3-D ``b``, ``dot_general`` NT and
batched, the attention ``einsum``, a 3-operand ``einsum``) in the modes
``fp32``, ``bf16``, ``fp8``, ``fp8_ls`` and ``s2fp8`` (fig4), forward and
gradients, against the JAX ``ref`` engine; ``truncate_output`` and
``output_dtype`` (the payload path too); the refusal of payload GEMMs
without the output truncation; the Fig. 4 fallback of a payload policy for
what the planner rejects; the non-payload ``flash_attention``;
``Policy.qdot``; and ``embed_tokens`` under bf16.  Inputs are drawn from
seeded numpy generators.

Tolerances.  fp32 and bf16 round no code: their products are exact in
f32 (bf16 operands are upcast exactly), so the two sides differ only by
the order of the f32 sums, held to 1e-6 of the same contraction over |a|
and |b| (|g| and the other operand for a gradient), plus one bf16
ulp (2^-7 of the value) where the result or the gradient is rounded to
bf16.  The truncating modes (fp8, fp8_ls, s2fp8) take the per-op flip
budget of ``tests/test_torch_fig4.py``: an element agrees within 1e-3
relative or is a flipped code, forward at most 0.2% flipped and none
further than 2% of max|value|, gradients at most 2% and 10%.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_reduced_config as jax_reduced_config
from repro.core import statsbank as jsb
from repro.core.policy import Policy as JaxPolicy
from repro.core.policy import make_policy as jax_policy
from repro.models import transformer as jtlm
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core import statsbank as tsb
from repro_torch.core.policy import MODES, Policy, make_policy
from repro_torch.models import transformer as tlm

jax.config.update("jax_platform_name", "cpu")

FWD = (2e-3, 0.02)
GRAD = (2e-2, 0.1)
EXACT_MODES = ("fp32", "bf16")
BF16_ULP = 2.0 ** -7

# (name, call on a policy, operand shapes, operand dtypes)
OPS = [
    ("dot", lambda p, a, b: p.dot(a, b), (4, 6, 32), (32, 24),
     ("bfloat16", "bfloat16")),
    ("dot_3d_b", lambda p, a, b: p.dot(a, b), (5, 16), (3, 16, 8),
     ("float32", "float32")),
    ("dot_general_nt", lambda p, a, b: p.dot_general(
        a, b, (((2,), (1,)), ((), ()))), (2, 5, 32), (40, 32),
     ("bfloat16", "float32")),
    ("dot_general_batched", lambda p, a, b: p.dot_general(
        a, b, (((2,), (1,)), ((0,), (0,)))), (3, 8, 16), (3, 16, 12),
     ("float32", "float32")),
    ("einsum_attention", lambda p, a, b: p.einsum(
        "bkgqd,bksd->bkgqs", a, b), (2, 2, 2, 8, 16), (2, 2, 8, 16),
     ("bfloat16", "bfloat16")),
]
# a 3-operand einsum: the planner takes two operands only
EINSUM3 = ("ab,bc,cd->ad", (6, 16), (16, 12), (12, 5))


def _torch(x, dtype=None):
    t = torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))
    return t if dtype is None else t.to(dtype)


def _flip_close(got, want, budget, step):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got - want)
    flipped = np.mean(d > 1e-3 * np.abs(want))
    worst = d.max() / max(np.abs(want).max(), 1e-30)
    assert flipped <= budget and worst <= step, (flipped, worst)


def _sum_close(got, want, abs_bound, rounded):
    """|got - want| <= 1e-6 * abs_bound (+ one bf16 rounding)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = 1e-6 * np.asarray(abs_bound, np.float32) + 1e-30
    if rounded:
        tol = tol + BF16_ULP * np.abs(want)
    d = np.abs(got - want)
    assert (d <= tol).all(), (d.max(), float((d - tol).max()))


def _run(call, tpol, jpol, arrays, dts, g_seed):
    """Forward and gradients of ``call`` on both sides from the same
    values: (port out, port grads, jax out, jax grads, cotangent)."""
    jin = [jnp.asarray(a).astype(getattr(jnp, d)) for a, d in zip(arrays,
                                                                   dts)]
    jy, vjp = jax.vjp(lambda *xs: call(jpol, *xs), *jin)
    g = (np.random.default_rng(g_seed).standard_normal(jy.shape) * 1e-2
         ).astype(np.float32)
    jgrads = vjp(jnp.asarray(g).astype(jy.dtype))
    tin = [_torch(x, getattr(torch, d)).requires_grad_() for x, d in
           zip(jin, dts)]
    ty = call(tpol, *tin)
    assert str(ty.dtype).split(".")[-1] == str(jy.dtype)
    ty.backward(torch.from_numpy(g).to(ty.dtype))
    for t in tin:
        assert t.grad.dtype == t.dtype
    return (ty.detach().float().numpy(), [t.grad.float().numpy()
                                          for t in tin],
            np.asarray(jy.astype(jnp.float32)),
            [np.asarray(x.astype(jnp.float32)) for x in jgrads], g)


def _abs_bounds(call, arrays, g, n):
    """The contraction over |operands| and its gradients at |g| (fp32,
    float64 sums): the scale of each side's f32 summation error."""
    pol = make_policy("fp32", "plain")
    xs = [torch.from_numpy(np.abs(np.asarray(a, np.float64)))
          .requires_grad_() for a in arrays]
    y = call(pol, *xs)
    y.backward(torch.from_numpy(np.abs(g).astype(np.float64)))
    return y.detach().numpy(), [x.grad.numpy() for x in xs[:n]]


def _operands(ash, bsh, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(ash).astype(np.float32)
    b = (rng.standard_normal(bsh) / np.sqrt(ash[-1])).astype(np.float32)
    return a, b


def _check(mode, call, res, arrays, rounded=False):
    """Exact modes: sums within 1e-6 of the |.| contraction, plus one bf16
    ulp where ``rounded``; truncating modes: the flip budgets."""
    ty, tg, jy, jg, g = res
    if mode in EXACT_MODES:
        ay, ag = _abs_bounds(call, arrays, g, len(arrays))
        _sum_close(ty, jy, ay, rounded)
        for t, j, a in zip(tg, jg, ag):
            _sum_close(t, j, a, rounded)
    else:
        _flip_close(ty, jy, *FWD)
        for t, j in zip(tg, jg):
            _flip_close(t, j, *GRAD)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "fp8", "fp8_ls", "s2fp8"])
@pytest.mark.parametrize("name,call,ash,bsh,dts", OPS,
                         ids=[o[0] for o in OPS])
def test_modes_match_jax_ref(mode, name, call, ash, bsh, dts):
    a, b = _operands(ash, bsh, len(name))
    tpol = make_policy(mode, "plain", "fig4", loss_scale=100.0)
    jpol = jax_policy(mode, loss_scale=100.0, backend="ref",
                      gemm_mode="fig4")
    res = _run(call, tpol, jpol, (a, b), dts, 7)
    # a bf16 operand, result or mode rounds once to bf16
    _check(mode, call, res, (a, b), mode == "bf16" or "bfloat16" in dts)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "fp8", "s2fp8"])
def test_three_operand_einsum_matches_jax_ref(mode):
    spec, *shapes = EINSUM3
    rng = np.random.default_rng(11)
    arrays = [rng.standard_normal(s).astype(np.float32) / 4 for s in shapes]
    dts = ("float32",) * 3

    def call(p, *xs):
        return p.einsum(spec, *xs)

    res = _run(call, make_policy(mode, "plain", "fig4"),
               jax_policy(mode, backend="ref", gemm_mode="fig4"), arrays,
               dts, 3)
    if mode in EXACT_MODES:
        # a 3-operand contraction over |x| bounds each summation order
        ty, tg, jy, jg, g = res
        ay, ag = _abs_bounds(call, arrays, g, 3)
        _sum_close(ty, jy, 2 * ay, mode == "bf16")
        for t, j, ab in zip(tg, jg, ag):
            _sum_close(t, j, 2 * ab, mode == "bf16")
    else:
        _check(mode, call, res, arrays)


def test_bf16_product_is_exact_in_f32():
    """The bf16 mode's product sums exact products in f32, as the
    reference's ``jnp.dot(bf16, bf16, preferred_element_type=f32)``: its
    f32 result equals the float64 product of the bf16-rounded operands
    within 1e-6 of |a| |b|, and is not bf16-rounded."""
    a, b = _operands((16, 64), (64, 24), 5)
    pol = make_policy("bf16", "plain")
    y = pol.dot(torch.from_numpy(a), torch.from_numpy(b))
    assert y.dtype == torch.float32
    ab = torch.from_numpy(a).bfloat16().double()
    bb = torch.from_numpy(b).bfloat16().double()
    want = (ab @ bb).numpy()
    bound = (ab.abs() @ bb.abs()).numpy()
    assert (np.abs(y.double().numpy() - want) <= 1e-6 * bound).all()
    assert not torch.equal(y, y.bfloat16().float())
    jy = jax_policy("bf16").dot(jnp.asarray(a), jnp.asarray(b))
    assert jy.dtype == jnp.float32
    assert (np.abs(y.numpy() - np.asarray(jy)) <= 1e-6 * bound).all()


# (mode, gemm_mode, truncate_output): payload without the output
# truncation is refused (test_payload_without_output_truncation_is_refused)
TRUNC_CASES = [(m, "fig4", t) for m in ("fp32", "bf16", "fp8", "s2fp8")
               for t in (True, False)] + [("s2fp8", "payload", True)]


@pytest.mark.parametrize("output_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("mode,gemm_mode,truncate_output", TRUNC_CASES)
def test_truncate_output_and_output_dtype_match_jax(
        mode, gemm_mode, truncate_output, output_dtype):
    a, b = _operands((8, 32), (32, 16), 2)
    kw = dict(mode=mode, truncate_output=truncate_output,
              output_dtype=output_dtype, gemm_mode=gemm_mode)
    tpol = Policy(backend="plain", **kw)
    jpol = JaxPolicy(backend="ref", **kw)
    assert tpol.uses_payload_gemm == jpol.uses_payload_gemm
    assert str(tpol.accum_dtype).split(".")[-1] == \
        str(jnp.dtype(jpol.accum_dtype))

    def call(p, x, y):
        return p.dot(x, y)

    res = _run(call, tpol, jpol, (a, b), ("float32", "float32"), 4)
    if output_dtype == "bfloat16" and mode in EXACT_MODES:
        # rounded at the GEMM boundary: every value on the bf16 grid
        ty = res[0]
        assert np.array_equal(ty, torch.from_numpy(ty).bfloat16().float())
    _check(mode, call, res, (a, b),
           mode == "bf16" or output_dtype == "bfloat16")


def test_truncate_output_false_leaves_the_output_untruncated():
    """Without the output truncation an fp8 GEMM output is the f32 product
    of the truncated operands: off the e5m2 grid, where the default's
    output lies on it."""
    a, b = _operands((8, 32), (32, 16), 9)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    on = make_policy("fp8", "plain").dot(ta, tb)
    off = Policy(mode="fp8", truncate_output=False,
                 backend="plain").dot(ta, tb)
    assert torch.equal(on, on.to(torch.float8_e5m2).float())
    assert not torch.equal(off, off.to(torch.float8_e5m2).float())
    want = (ta.to(torch.float8_e5m2).float()
            @ tb.to(torch.float8_e5m2).float())
    assert (off - want).abs().max() <= 1e-6 * (ta.abs() @ tb.abs()).max()


def test_payload_without_output_truncation_is_refused():
    with pytest.raises(ValueError, match="truncate_output"):
        Policy(mode="s2fp8", gemm_mode="payload", truncate_output=False)
    with pytest.raises(ValueError, match="truncate_output"):
        JaxPolicy(mode="s2fp8", gemm_mode="payload", truncate_output=False)
    # auto resolves to the chain instead, on both sides
    pol = Policy(mode="s2fp8", backend="cuda", truncate_output=False)
    jpol = JaxPolicy(mode="s2fp8", backend="pallas", truncate_output=False)
    assert not pol.uses_payload_gemm and not jpol.uses_payload_gemm


def test_make_policy_modes_and_loss_scale():
    assert set(MODES) == {"fp32", "bf16", "fp8", "fp8_ls", "s2fp8",
                          "s2fp8_e4m3"}
    for mode in MODES:
        t = make_policy(mode, "plain", "fig4", loss_scale=100.0)
        j = jax_policy(mode, 100.0, "ref", "fig4")
        assert (t.mode, t.loss_scale, t.truncate_output, t.output_dtype) == \
            (j.mode, j.loss_scale, j.truncate_output, j.output_dtype)
    assert make_policy("fp8_ls").loss_scale == jax_policy("fp8_ls").loss_scale
    with pytest.raises(ValueError):
        make_policy("fp16")


FALLBACK = [
    ("dot_3d_b", lambda p, a, b: p.dot(a, b), (5, 16), (3, 16, 8)),
    ("einsum_rejected", lambda p, a, b: p.einsum("abd,dc->bac", a, b),
     (4, 6, 24), (24, 10)),
]


@pytest.mark.parametrize("name,call,ash,bsh", FALLBACK,
                         ids=[f[0] for f in FALLBACK])
def test_payload_falls_back_to_fig4_as_the_reference(name, call, ash, bsh):
    """A payload policy runs the Fig. 4 chain where the planner has no
    layout (a ``dot`` whose ``b`` is 3-D, a permuted einsum output), as
    the reference's does: held against the JAX payload policy on ``ref``,
    forward and gradients, and no payload GEMM runs."""
    from repro_torch import kernels
    a, b = _operands(ash, bsh, len(name) + 1)
    kernels.reset_counts()
    res = _run(call, make_policy("s2fp8", "plain", "payload"),
               jax_policy("s2fp8", backend="ref", gemm_mode="payload"),
               (a, b), ("float32", "float32"), 5)
    _check("s2fp8", call, res, (a, b))
    assert all(c["plain_calls"] == 0 for n, c in kernels.counts().items()
               if n.startswith("qmatmul"))


def test_payload_three_operand_einsum_falls_back():
    spec, *shapes = EINSUM3
    rng = np.random.default_rng(12)
    arrays = [rng.standard_normal(s).astype(np.float32) / 4 for s in shapes]

    def call(p, *xs):
        return p.einsum(spec, *xs)

    res = _run(call, make_policy("s2fp8", "plain", "payload"),
               jax_policy("s2fp8", backend="ref", gemm_mode="payload"),
               arrays, ("float32",) * 3, 6)
    _check("s2fp8", call, res, arrays)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "fp8_ls", "s2fp8"])
def test_non_payload_flash_attention_matches_jax(mode):
    """``flash_attention`` outside payload: the q/k/v truncations, the
    chunked flash attention of ``models/flash.py`` and the output
    truncation, against the JAX policy's (``repro.models.flash``), forward
    and gradients; the last 32 query positions x 2 groups over 64 keys,
    f32 inputs (the bf16 mode casts them).  Causal over Sq = Sk, the first
    query row attends to its own key only and its dq is rounding noise
    (~1e-9, zero in exact arithmetic), whose log2 moves dq's exact stats
    and shifts its whole s2fp8 grid on either side; here every row sees
    at least 33 keys."""
    rng = np.random.default_rng(21)
    q = rng.standard_normal((1, 2, 2, 32, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, 64, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, 64, 16)).astype(np.float32)

    def call(p, q_, k_, v_):
        return p.flash_attention(q_, k_, v_, causal=True)

    res = _run(call, make_policy(mode, "plain", "fig4"),
               jax_policy(mode, backend="ref", gemm_mode="fig4"), (q, k, v),
               ("float32",) * 3, 8)
    ty, tg, jy, jg, _ = res
    if mode in EXACT_MODES:
        # softmax outputs rounded to bf16: one bf16 rounding of |out|
        for t, j in [(ty, jy)] + list(zip(tg, jg)):
            d = np.abs(t - j)
            assert (d <= BF16_ULP * np.abs(j) + 1e-5 * np.abs(j).max()
                    ).all(), d.max()
    else:
        _flip_close(ty, jy, *FWD)
        for t, j in zip(tg, jg):
            _flip_close(t, j, *GRAD)


def _qdot_bank(seed):
    """A bank with refreshed moments at the sites ``Policy.qdot`` reads
    under a session: q0, q1 (its operands) and t0 (its output)."""
    rng = np.random.default_rng(seed)

    def state(mu, m):
        return {"alpha": np.float32(1.0), "beta": np.float32(0.0),
                "ema_mu": np.float32(mu), "ema_m": np.float32(m),
                "last": np.float32(3.0)}

    bank = {"q0": {"fwd": state(rng.uniform(-3, -1), rng.uniform(0, 2))},
            "q1": {"fwd": state(rng.uniform(-6, -4), rng.uniform(-3, -1))},
            "t0": {"fwd": state(-2.5, 1.5), "bwd": state(-2.5, 1.5)}}
    return ({k: {d: {f: jnp.asarray(v) for f, v in st.items()}
                 for d, st in e.items()} for k, e in bank.items()},
            {k: {d: {f: torch.tensor(float(v)) for f, v in st.items()}
                 for d, st in e.items()} for k, e in bank.items()})


@pytest.mark.parametrize("session", [False, True])
def test_qdot_matches_jax(session):
    """``Policy.qdot``: quantize both operands (exact stats, or the
    read-only stats of their q sites under a session), one payload GEMM,
    the output truncation; against the JAX ``ref`` policy's.  4,096
    outputs, so that the 0.2% budget admits a few flipped codes (the
    payload ``dot`` flips one of 384 outputs at 16 x 48 x 24, its own
    parity)."""
    a, b = _operands((64, 96), (96, 64), 13)
    tpol = make_policy("s2fp8", "plain")
    jpol = jax_policy("s2fp8", backend="ref")
    if session:
        jbank, tbank = _qdot_bank(2)
        with jsb.freeze(jbank):
            jy = jpol.qdot(jnp.asarray(a), jnp.asarray(b))
        with tsb.freeze(tbank):
            ty = tpol.qdot(torch.from_numpy(a), torch.from_numpy(b))
    else:
        jy = jpol.qdot(jnp.asarray(a), jnp.asarray(b))
        ty = tpol.qdot(torch.from_numpy(a), torch.from_numpy(b))
    assert ty.dtype == torch.float32 and not ty.requires_grad
    _flip_close(ty.numpy(), np.asarray(jy), *FWD)
    # the fp32 policy's qdot is its dot
    f = make_policy("fp32").qdot(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(f, torch.from_numpy(a) @ torch.from_numpy(b))


def test_qdot_operand_sites_are_discovered_and_read_only():
    """Under discovery ``qdot`` mints two "fwd"-only ``q`` sites and its
    output's ``t`` site, as the reference's ``operand_stats`` does; a
    train step leaves them as they were (merge_updates carries them) and
    ``force_refresh`` does not touch them."""
    a, b = _operands((8, 16), (16, 8), 1)
    pol = make_policy("s2fp8", "plain")

    def loss_fn(params, batch, policy):
        return policy.qdot(params["embed"], batch).sum(), {}

    params = {"embed": torch.from_numpy(a)}
    bank = tsb.init_bank(loss_fn, params, torch.from_numpy(b), pol)
    assert {k: tuple(e) for k, e in bank.items()} == {
        "q0": ("fwd",), "q1": ("fwd",), "t0": ("fwd", "bwd")}
    forced = tsb.force_refresh(bank)
    assert forced["q0"] is bank["q0"]
    assert float(forced["t0"]["fwd"]["last"]) == -1.0


def test_embed_tokens_truncate_only_in_truncating_modes():
    """bf16 gathers the table untruncated, as the reference's (which
    truncates in s2fp8, s2fp8_e4m3, fp8 and fp8_ls only); fp8_ls
    truncates as fp8 does."""
    jcfg = jax_reduced_config("minicpm_2b").replace(n_layers=1, vocab=64)
    cfg = get_reduced_config("minicpm_2b").replace(n_layers=1, vocab=64)
    params = jtlm.init_lm(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.device_get(params), device="cpu")
    tokens = np.random.default_rng(0).integers(0, 64, (2, 8))
    for mode in ("bf16", "fp8_ls", "fp8", "fp32"):
        jx = jtlm.embed_tokens(params, jnp.asarray(tokens), jcfg,
                               jax_policy(mode, backend="ref"))
        tx = tlm.embed_tokens(tparams, torch.from_numpy(tokens), cfg,
                              make_policy(mode, "plain"))
        assert tx.dtype == torch.bfloat16
        assert np.array_equal(tx.float().numpy(),
                              np.asarray(jx.astype(jnp.float32))), mode
    raw = tparams["embed"][torch.from_numpy(tokens)].bfloat16()
    assert torch.equal(tlm.embed_tokens(tparams, torch.from_numpy(tokens),
                                        cfg, make_policy("bf16")), raw)
