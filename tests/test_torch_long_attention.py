"""Long-sequence attention of the port against the JAX package, on the CPU:
``models/flash.flash_attention`` (the chunked flash attention with the
recompute backward), ``blocks.chunked_attention`` (the naive chunked
path), and a reduced minicpm trained one step above 2048 tokens with
``attn_impl`` naive and flash.

Inputs come from seeded numpy generators; the JAX side is
``repro.models.flash`` / ``repro.models.blocks`` (plain JAX, the
reference's own CPU path) and, for the model, ``repro.models.transformer``
with the ``ref`` engine.  Tolerances are stated beside each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_reduced_config as jax_reduced_config
from repro.core.policy import make_policy as jax_policy
from repro.models import blocks as jblocks
from repro.models import flash as jflash
from repro.models import transformer as jtlm
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import make_policy
from repro_torch.models import blocks, flash
from repro_torch.models import transformer as tlm
from repro_torch.optim.optimizers import tree_leaves

jax.config.update("jax_platform_name", "cpu")

FWD = (2e-3, 0.02)
GRAD = (2e-2, 0.1)


def _flip_close(got, want, budget, step):
    d = np.abs(got - want)
    flipped = np.mean(d > 1e-3 * np.abs(want))
    worst = d.max() / max(np.abs(want).max(), 1e-30)
    assert flipped <= budget and worst <= step, (flipped, worst)


def _qkv(b, kvh, g, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, kvh, g, sq, d)).astype(np.float32),
            rng.standard_normal((b, kvh, sk, d)).astype(np.float32),
            rng.standard_normal((b, kvh, sk, d)).astype(np.float32))


# (causal, window, G, Sq, Sk): chunks of 16 x 16, so 2-4 chunks a side
FLASH_CASES = [(True, None, 1, 64, 64), (False, None, 1, 64, 64),
               (True, 24, 1, 64, 64), (True, None, 2, 32, 64),
               (False, 20, 2, 48, 32)]


@pytest.mark.parametrize("causal,window,g,sq,sk", FLASH_CASES)
def test_flash_attention_matches_jax(causal, window, g, sq, sk):
    """Forward and dq, dk, dv in f32, 16 x 16 chunks: within 1e-5 *
    max|JAX| (the same loops; the einsums sum in another order)."""
    q, k, v = _qkv(1, 2, g, sq, sk, 16, sq + sk + g)
    dout = np.random.default_rng(1).standard_normal(q.shape).astype(
        np.float32)

    def jf(q_, k_, v_):
        return jflash.flash_attention(q_, k_, v_, causal, window, 16, 16)

    jy, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ty = flash.flash_attention(tq, tk, tv, causal, window, 16, 16)
    ty.backward(torch.from_numpy(dout))
    for got, want in [(ty.detach(), jy), (tq.grad, jg[0]), (tk.grad, jg[1]),
                      (tv.grad, jg[2])]:
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_flash_attention_keeps_only_out_and_lse():
    """The recompute backward: the node saves q, k, v, the output and the
    rowwise logsumexp, nothing of size Sq x Sk; and the gradients equal
    those of the naive chunked path (autograd through the loops) within
    1e-5 of their max."""
    q, k, v = _qkv(1, 1, 1, 64, 64, 8, 3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    y = flash.flash_attention(tq, tk, tv, True, None, 16, 16)
    saved = y.grad_fn.saved_tensors
    assert max(t.numel() for t in saved) == q.size
    assert sorted(tuple(t.shape) for t in saved)[0] == (1, 1, 1, 64, 1)
    y.sum().backward()
    fq, fk, fv = tq.grad, tk.grad, tv.grad
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    blocks.chunked_attention(tq, tk, tv, q_chunk=16, kv_chunk=16).sum(
        ).backward()
    for a, b in ((fq, tq.grad), (fk, tk.grad), (fv, tv.grad)):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_chunks_must_divide_the_sequence():
    """As the reference asserts: S % min(chunk, S) == 0."""
    q, k, v = (torch.zeros(s) for s in ((1, 1, 1, 40, 8), (1, 1, 40, 8),
                                        (1, 1, 40, 8)))
    with pytest.raises(ValueError, match="chunked attention"):
        flash.flash_attention(q, k, v, True, None, 16, 16)
    with pytest.raises(ValueError, match="chunked attention"):
        blocks.chunked_attention(q, k, v, q_chunk=16, kv_chunk=16)


@pytest.mark.parametrize("mode", [None, "fp32", "s2fp8"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_chunked_attention_matches_jax(mode, causal, window):
    """``chunked_attention`` with 16 x 16 chunks over 64 positions, G = 2,
    without a policy, with fp32 and with s2fp8 (fig4, exact stats: q, k,
    v and the output truncated at their sites), bf16 q/k/v as a block
    passes them; forward and gradients.  Without truncation: within one
    bf16 ulp (2^-7 of |value|) + 1e-5 of max (bf16 outputs and gradients
    of f32 sums in another order); s2fp8: the fig4 per-op flip budget
    (forward 0.2% of the elements beyond 1e-3 relative, none beyond 2% of
    max; gradients 2% and 10%)."""
    q, k, v = _qkv(1, 2, 2, 64, 64, 16, 5)
    dout = (np.random.default_rng(2).standard_normal(q.shape) * 0.1
            ).astype(np.float32)
    jpol = None if mode is None else jax_policy(mode, backend="ref",
                                                gemm_mode="fig4")
    tpol = None if mode is None else make_policy(mode, "plain", "fig4")

    def jf(q_, k_, v_):
        return jblocks.chunked_attention(q_, k_, v_, causal=causal,
                                         window=window, q_chunk=16,
                                         kv_chunk=16, policy=jpol)

    ins = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    jy, vjp = jax.vjp(jf, *ins)
    jg = vjp(jnp.asarray(dout).astype(jnp.bfloat16))
    tin = [torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
           .requires_grad_() for x in ins]
    ty = blocks.chunked_attention(*tin, causal=causal, window=window,
                                  q_chunk=16, kv_chunk=16, policy=tpol)
    assert ty.dtype == torch.bfloat16
    ty.backward(torch.from_numpy(dout).bfloat16())
    pairs = [(ty.detach(), jy)] + [(t.grad, j) for t, j in zip(tin, jg)]
    for i, (got, want) in enumerate(pairs):
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        if mode == "s2fp8":
            _flip_close(got, want, *(FWD if i == 0 else GRAD))
        else:
            d = np.abs(got - want)
            assert (d <= 2.0 ** -7 * np.abs(want)
                    + 1e-5 * np.abs(want).max()).all(), d.max()


S_LONG = 3072
JCFG = jax_reduced_config("minicpm_2b").replace(n_layers=2, vocab=256)
TCFG = get_reduced_config("minicpm_2b").replace(n_layers=2, vocab=256)


@pytest.fixture(scope="module")
def long_batch():
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, JCFG.vocab, (1, S_LONG)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    params = jtlm.init_lm(JCFG, jax.random.PRNGKey(3))
    return tokens, labels, params


# (mode, gemm_mode, activation dtype): budgets of (|loss diff|, per-leaf
# relative gradient difference ||port - jax|| / ||jax||, the largest over
# the leaves)
LONG_CASES = {("fp32", "fig4", "float32"): (1e-5, 1e-4),
              ("s2fp8", "fig4", "bfloat16"): (0.01, 0.2),
              ("s2fp8", "payload", "bfloat16"): (0.01, 0.2)}


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
@pytest.mark.parametrize("mode,gemm_mode,act", list(LONG_CASES))
def test_reduced_minicpm_above_2048_tokens_matches_jax(
        long_batch, mode, gemm_mode, act, attn_impl):
    """Reduced minicpm (2 layers, d 128, 4 heads of 32, vocab 256, remat)
    at batch 1 x 3072 tokens: above 2048 each block attends through the
    chunked path (naive) or ``Policy.flash_attention`` (flash: on the
    payload path the payload flash node, else ``models/flash.py``), in
    1024 x 1024 chunks.  Loss and every gradient leaf against the JAX
    model's on the ``ref`` engine.  fp32 with f32 activations: loss
    within 1e-5 and each leaf within 1e-4 relative (f32 sums in another
    order; with the model's bf16 activations a bf16 rounding that the
    order moves spreads to ~1.3% a leaf at 256 tokens as at 3072, so the
    chunked paths are held in f32).  s2fp8 with bf16 activations, exact
    stats: loss within 0.01 (measured up to 4.1e-4) and each leaf within
    20% relative (measured 2.7-10.0%, every leaf alike, and 5.4-9.9% at
    256 tokens through the full attention): every cotangent is truncated
    to e5m2 with exact stats, and stats that differ in their last bits
    (log2/exp2 and sums in another order) move whole grids, so the two
    sides' gradients carry independent e5m2 rounding noise (per-call
    parity is held in the node and policy tests)."""
    tokens, labels, jparams = long_batch
    jcfg, tcfg = (c.replace(attn_impl=attn_impl, activation_dtype=act)
                  for c in (JCFG, TCFG))
    jpol = jax_policy(mode, backend="ref", gemm_mode=gemm_mode)

    def jloss(p):
        return jtlm.loss_fn(p, jnp.asarray(tokens), jnp.asarray(labels),
                            jcfg, jpol)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tl, _ = tlm.loss_fn(params, torch.from_numpy(tokens).long(),
                        torch.from_numpy(labels).long(), tcfg,
                        make_policy(mode, "plain", gemm_mode))
    tg = torch.autograd.grad(tl, leaves)
    lim_loss, lim_grad = LONG_CASES[(mode, gemm_mode, act)]
    tl = float(tl.detach())
    assert abs(tl - float(jl)) <= lim_loss, (tl, float(jl))
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(tg)
    rel = [float(np.linalg.norm(t.numpy() - np.asarray(j))
                 / max(np.linalg.norm(np.asarray(j)), 1e-30))
           for t, j in zip(tg, jleaves)]
    assert max(rel) <= lim_grad, rel


def test_blocks_above_2048_take_the_configured_path(monkeypatch):
    """One block at 3072 tokens: naive runs ``chunked_attention``, flash
    runs ``Policy.flash_attention``; 2048 tokens run ``full_attention``."""
    calls = []
    for name in ("chunked_attention", "full_attention"):
        real = getattr(blocks, name)
        monkeypatch.setattr(blocks, name, (lambda r, n: lambda *a, **k: (
            calls.append(n), r(*a, **k))[1])(real, name))
    real_fa = flash.flash_attention
    monkeypatch.setattr(flash, "flash_attention", lambda *a, **k: (
        calls.append("flash"), real_fa(*a, **k))[1])
    cfg = TCFG.replace(n_layers=1)
    params = tlm.init_lm(cfg, seed=0, device="cpu")
    pol = make_policy("fp32", "plain")
    for impl, s in (("naive", 3072), ("flash", 3072), ("flash", 2048)):
        toks = torch.zeros((1, s), dtype=torch.long)
        with torch.no_grad():
            tlm.loss_fn(params, toks, toks, cfg.replace(attn_impl=impl), pol)
    assert calls == ["chunked_attention", "flash", "full_attention"]
