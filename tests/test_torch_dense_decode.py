"""The port's dense-cache attention decode against the JAX package, on the
CPU: ``blocks.decode_attention``, the dense decode branch of
``attn_block_apply`` (a scalar and a per-slot cache index, a sliding
window as a ring buffer and as a mask, under a frozen StatsBank session),
and reduced minicpm_2b served by ``LMServer`` beside the JAX ``LMServer``.

Inputs and params come from seeded numpy / JAX generators; params cross
with ``params_from_jax``.  The JAX block runs the window as a ``local``
block (``cfg.window``); the port has no ``local`` block type and takes the
window as ``attn_block_apply``'s ``window``.  Tolerances are stated beside
each test.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_reduced_config as jax_reduced_config
from repro.core import statsbank as jsb
from repro.core.policy import make_policy as jax_policy
from repro.launch import api
from repro.models import blocks as jblocks
from repro.models import transformer as jtlm
from repro.serving.engine import LMServer as JaxLMServer
from repro.serving.engine import Request as JaxRequest
from repro_torch import kernels
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core import statsbank as tsb
from repro_torch.core.policy import make_policy
from repro_torch.models import blocks
from repro_torch.serving.engine import LMServer, Request

jax.config.update("jax_platform_name", "cpu")

FWD = (2e-3, 0.02)
ARCH = "minicpm_2b"


def _flip_close(got, want, budget, step):
    d = np.abs(got - want)
    flipped = np.mean(d > 1e-3 * np.abs(want))
    worst = d.max() / max(np.abs(want).max(), 1e-30)
    assert flipped <= budget and worst <= step, (flipped, worst)


def _np(x):
    """A copy as f32 numpy (the port's caches change in place)."""
    return (x.detach().float().numpy().copy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x).astype(jnp.float32)))


@pytest.mark.parametrize("valid_kind", ["shared", "per_slot", "window"])
@pytest.mark.parametrize("mode", [None, "fp32", "s2fp8_fig4",
                                  "s2fp8_payload"])
def test_decode_attention_matches_jax(valid_kind, mode):
    """One query token of 3 slots x 2 KV heads x G 2 over a 24-slot cache:
    ``valid`` [Smax] (every row at position 17), [B, Smax] (rows at 5, 17
    and 23) or a window of 6 behind each row.  Without a policy and in
    fp32: within 1e-5 * max (f32 softmax and sums in another order);
    s2fp8 (fig4, and payload: the batched payload GEMM's plain version
    with one query row a group): the fig4 forward flip budget (at most
    0.2% of the outputs beyond 1e-3 relative, none beyond 2% of max)."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 2, 2, 1, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 2, 24, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 2, 24, 16)).astype(np.float32)
    pos = np.array([5, 17, 23])
    kpos = np.arange(24)
    if valid_kind == "shared":
        valid = kpos <= 17
    elif valid_kind == "per_slot":
        valid = kpos[None, :] <= pos[:, None]
    else:
        valid = (kpos[None, :] <= pos[:, None]) & (kpos[None, :]
                                                   > pos[:, None] - 6)
    if mode is None:
        jpol = tpol = None
    else:
        m, gm = (mode, "fig4") if mode == "fp32" else mode.split("_")
        jpol = jax_policy(m, backend="ref", gemm_mode=gm)
        # the cuda engine takes the kernels' plain versions on CPU tensors
        # (counted), with the plain engine's numerics
        tpol = make_policy(m, "cuda" if gm == "payload" else "plain", gm)
    jy = jblocks.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(valid),
                                  policy=jpol)
    kernels.reset_counts()
    ty = blocks.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc),
                                 torch.from_numpy(valid), policy=tpol)
    if mode == "s2fp8_payload":
        assert kernels.counts()["qmatmul_batched"]["plain_calls"] == 2
    got, want = _np(ty), _np(jy)
    assert got.shape == want.shape == q.shape
    if mode is not None and mode.startswith("s2fp8"):
        _flip_close(got, want, *FWD)
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _block(n_kv=2, window=0):
    """(JAX cfg, port cfg, JAX layer params, port layer params) of one
    reduced minicpm block: d 64, 4 heads of 16 over ``n_kv`` KV heads."""
    kw = dict(n_layers=1, d_model=64, n_heads=4, kv_heads=n_kv,
              head_dim=16, d_ff=128, vocab=64)
    jcfg = jax_reduced_config(ARCH).replace(window=window, **kw)
    tcfg = get_reduced_config(ARCH).replace(**kw)
    params = jtlm.init_lm(jcfg, jax.random.PRNGKey(2))
    jp = jax.tree_util.tree_map(lambda x: x[0], params["segments"][0])
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    return jcfg, tcfg, jp, tp


# (index kind, window, Smax): the window cases run a ring buffer (Smax <=
# window) and a masked linear cache (Smax > window)
DECODE_CASES = [("scalar", 0, 16), ("per_slot", 0, 16), ("scalar", 8, 8),
                ("per_slot", 8, 8), ("per_slot", 4, 16), ("scalar", 4, 16)]


def _decode_both(jcfg, tcfg, jp, tp, jpol, tpol, index_kind, window, smax,
                 steps=3, seed=0, sessions=None):
    """``steps`` dense decode steps of one block on both sides, from caches
    holding random K/V, each step under ``sessions()`` (a pair of context
    managers, JAX and port) when given; returns per step (JAX out, port
    out, JAX cache, port cache) as numpy."""
    rng = np.random.default_rng(seed)
    b, kvh, hd = 3, tcfg.kv_heads, tcfg.resolved_head_dim
    kc = rng.standard_normal((b, kvh, smax, hd)).astype(np.float32)
    vc = rng.standard_normal((b, kvh, smax, hd)).astype(np.float32)
    jcache = {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}
    tcache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(
        vc.copy())}
    start = np.array([3, 9, 13]) if index_kind == "per_slot" else 9
    out = []
    for t in range(steps):
        x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
        ci = start + t
        if index_kind == "per_slot":
            jpos = jnp.asarray(ci[:, None], jnp.int32)
            tpos = torch.from_numpy(ci[:, None]).int()
            jci, tci = jnp.asarray(ci, jnp.int32), torch.from_numpy(ci)
        else:
            jpos = jnp.full((1,), ci, jnp.int32)
            tpos = torch.full((1,), ci, dtype=torch.int32)
            jci, tci = jnp.int32(ci), ci
        jx = jnp.asarray(x).astype(jnp.bfloat16)
        tx = torch.from_numpy(x).bfloat16()
        jctx, tctx = (sessions() if sessions else
                      (contextlib.nullcontext(), contextlib.nullcontext()))
        with jctx:
            jy, jcache, _ = jblocks.attn_block_apply(
                jp, jx, jcfg, jpol, jpos, jcache, jci, "decode",
                "local" if window else "dense")
        with torch.no_grad(), tctx:
            ty, tcache, _ = blocks.attn_block_apply(
                tp, tx, tcfg, tpol, tpos, tcache, tci, "decode", "dense",
                window=window or None)
        out.append((_np(jy), _np(ty), {k: _np(v) for k, v in jcache.items()},
                    {k: _np(v) for k, v in tcache.items()}))
    return out


@pytest.mark.parametrize("index_kind,window,smax", DECODE_CASES)
def test_dense_decode_branch_matches_jax(index_kind, window, smax):
    """Three decode steps of one block in fp32 (bf16 activations), 3 rows
    over 2 KV heads (G 2): each step's block output within one bf16 ulp
    (2^-7 of |value|) + 1e-4 of max (bf16 roundings of f32 sums in
    another order), and the caches equal (the new K/V rows are the
    projections, rounded once to bf16 and cast to f32 on both sides;
    within the same bound)."""
    jcfg, tcfg, jp, tp = _block(window=window)
    pol = (jax_policy("fp32"), make_policy("fp32"))
    for jy, ty, jc, tc in _decode_both(jcfg, tcfg, jp, tp, *pol,
                                       index_kind, window, smax):
        for got, want in [(ty, jy), (tc["k"], jc["k"]), (tc["v"], jc["v"])]:
            assert got.shape == want.shape
            d = np.abs(got - want)
            assert (d <= 2.0 ** -7 * np.abs(want)
                    + 1e-4 * np.abs(want).max()).all(), d.max()


def _random_moments(bank, seed):
    """``bank`` (JAX, from discovery) with refreshed-looking moments at
    every site: mu in [-4, -1], m in [0, 3], last 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, entry in bank.items():
        out[key] = {}
        for d, st in entry.items():
            out[key][d] = dict(st, ema_mu=jnp.float32(rng.uniform(-4, -1)),
                               ema_m=jnp.float32(rng.uniform(0, 3)),
                               last=jnp.float32(0.0))
    return out


@pytest.mark.parametrize("index_kind,window,smax",
                         [("scalar", 0, 16), ("per_slot", 8, 8)])
def test_dense_decode_under_a_session_matches_jax(index_kind, window,
                                                  smax):
    """Under a frozen session the new K/V are truncated at the block's
    kv_cache/t0, t1 sites before they are written (reference
    blocks.py:439-447), as every other site of the block: s2fp8 fig4 over
    one bank (the JAX discovery's keys, which the port's session must
    find), three decode steps.  Outputs and caches: the fig4 forward flip
    budget; the cache rows written are on the kv_cache sites' grids."""
    jcfg, tcfg, jp, tp = _block(window=window)
    jpol = jax_policy("s2fp8", backend="ref", gemm_mode="fig4")
    tpol = make_policy("s2fp8", "plain", "fig4")
    b, kvh, hd = 3, tcfg.kv_heads, tcfg.resolved_head_dim
    cache0 = {"k": jnp.zeros((b, kvh, smax, hd)),
              "v": jnp.zeros((b, kvh, smax, hd))}

    def probe(p, x, pol):
        ci = (jnp.array([3, 9, 13], jnp.int32) if index_kind == "per_slot"
              else jnp.int32(9))
        pos = ci[:, None] if index_kind == "per_slot" else jnp.full((1,), 9)
        y, _, _ = jblocks.attn_block_apply(
            p, x, jcfg, pol, pos, cache0, ci, "decode",
            "local" if window else "dense")
        return y.astype(jnp.float32).sum(), {}

    bank = _random_moments(jsb.init_bank(
        probe, jp, jnp.zeros((b, 1, tcfg.d_model), jnp.bfloat16), jpol,
        jsb.StatsConfig()), 1)
    assert {"kv_cache/t0", "kv_cache/t1"} <= set(bank)
    tbank = {k: {d: {f: torch.tensor(float(v)) for f, v in st.items()}
                 for d, st in e.items()} for k, e in bank.items()}
    steps = _decode_both(jcfg, tcfg, jp, tp, jpol, tpol, index_kind, window,
                         smax, sessions=lambda: (jsb.freeze(bank),
                                                 tsb.freeze(tbank)))
    for jy, ty, jc, tc in steps:
        _flip_close(ty, jy, *FWD)
        for key in ("k", "v"):
            _flip_close(tc[key], jc[key], *FWD)


def _serve(server, request_cls, prompts, new_tokens):
    """Serve to completion: each request's tokens and, per prefill or
    decode call, (last-position logits [slots, V] f32, [(row, request,
    tokens emitted so far)])."""
    reqs = [request_cls(prompt=p, max_new_tokens=n)
            for p, n in zip(prompts, new_tokens)]
    steps = []
    prefill, decode = server._prefill, server._decode

    def logits_np(out):
        lg = out[0][:, -1]
        return (lg.float().numpy() if isinstance(lg, torch.Tensor)
                else np.asarray(lg, np.float32))

    def p(*args):
        toks = np.asarray(args[1])
        rows = [(r, i, 0) for r, row in enumerate(toks)
                for i, pr in enumerate(prompts)
                if np.array_equal(row[:len(pr)], pr)
                and not row[len(pr):].any()]
        out = prefill(*args)
        steps.append((logits_np(out), rows))
        return out

    def d(*args):
        rows = [(s, next(i for i, q in enumerate(reqs) if q is r), len(r.out))
                for s, r in enumerate(server.slot_req) if r is not None]
        out = decode(*args)
        steps.append((logits_np(out), rows))
        return out

    server._prefill, server._decode = p, d
    for r in reqs:
        server.submit(r)
    server.run_to_completion()
    return [r.out for r in reqs], steps


LENGTHS, NEW_TOKENS, SLOTS, MAX_LEN = (5, 8, 3, 11, 6), (6, 4, 6, 3, 5), 3, 32


@pytest.fixture(scope="module")
def served():
    cfg_j = jax_reduced_config(ARCH).replace(n_layers=2)
    cfg = get_reduced_config(ARCH).replace(n_layers=2)
    params_j = api.init_params(cfg_j, jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(params_j), device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, n, dtype=np.int32) for n in LENGTHS]
    out = {}
    for name, mode, gm in (("fp32", "fp32", "fig4"),
                           ("s2fp8_fig4", "s2fp8", "fig4"),
                           ("s2fp8_payload", "s2fp8", "payload")):
        kernels.reset_counts()
        engine = "cuda" if gm == "payload" else "plain"
        port = _serve(LMServer(cfg, params, make_policy(mode, engine, gm),
                               slots=SLOTS, max_len=MAX_LEN), Request,
                      prompts, NEW_TOKENS)
        out[name] = {"counts": kernels.counts(), "port": port,
                     "jax": _serve(JaxLMServer(
                         cfg_j, params_j, jax_policy(mode, backend="ref",
                                                     gemm_mode=gm),
                         slots=SLOTS, max_len=MAX_LEN), JaxRequest,
                         prompts, NEW_TOKENS)}
    return out


def test_lmserver_fp32_greedy_tokens_match_jax(served):
    """fp32: the same greedy tokens for every request, and at every
    prefill and decode call the logits of every live row within max
    |diff| <= 0.05 and mean <= 0.01 (bf16 activations rounded after sums
    in another order; the dense-serving test's fp32 bound)."""
    (tj, sj), (tt, st) = served["fp32"]["jax"], served["fp32"]["port"]
    assert tt == tj
    assert [len(t) for t in tt] == list(NEW_TOKENS)
    assert [r for _, r in st] == [r for _, r in sj]
    for (lj, rows), (lt, _) in zip(sj, st):
        idx = [r for r, _, _ in rows]
        d = np.abs(lt[idx] - lj[idx])
        assert d.max() <= 0.05 and d.mean() <= 0.01, (d.max(), d.mean())


@pytest.mark.parametrize("run", ["s2fp8_fig4", "s2fp8_payload"])
def test_lmserver_s2fp8_matches_jax(served, run):
    """s2fp8 with exact per-call stats: fig4 on the plain engine, and
    payload on the cuda engine, whose wrappers take the kernels' plain
    versions on the CPU (the decode's two einsums on the batched payload
    GEMM's, the prefill attention on the payload flash forward's).  At
    every call the rows
    whose tokens so far agree keep logits within max |diff| <= 0.15 and
    mean <= 0.03 (measured: 0.026-0.047 / 0.008-0.009 at the prefills,
    the ROADMAP queue 3 prefill budget's size, growing to 0.093 / 0.022
    over the decode steps, where every call's exact stats are reduced
    anew over all slots and a moved code spreads through the cache); and
    where a request's tokens part, they part at a near-tie: the JAX
    logits of the two choices at that call within the same 0.15 (one of
    the five requests parts at its first token on each path)."""
    (tj, sj), (tt, st) = served[run]["jax"], served[run]["port"]
    if run == "s2fp8_payload":
        assert served[run]["counts"]["qmatmul_batched"]["plain_calls"] > 0
        assert served[run]["counts"]["qflash_fwd"]["plain_calls"] > 0
    compared = 0
    for (lj, rows_j), (lt, rows_t) in zip(sj, st):
        assert np.isfinite(lt[[r for r, _, _ in rows_t]]).all()
        agree = [r for r, i, n in rows_t if (r, i, n) in rows_j
                 and tt[i][:n] == tj[i][:n]]
        if agree:
            d = np.abs(lt[agree] - lj[agree])
            assert d.max() <= 0.15 and d.mean() <= 0.03, (d.max(), d.mean())
            compared += len(agree)
        for r, i, n in rows_t:
            if (tt[i][:n] == tj[i][:n] and n < len(tt[i])
                    and tt[i][n] != tj[i][n]):
                margin = lj[r, tj[i][n]] - lj[r, tt[i][n]]
                assert 0 <= margin <= 0.15, (i, n, margin)
    assert compared >= len(LENGTHS) + 10
