"""The port's serving slice end to end against the JAX package, on the CPU.

Reduced minicpm_2b (2 layers, d=128, hd=32, vocab 512); params made by
``repro.launch.api.init_params`` and carried across with
``params_from_jax``; frozen banks made on the JAX side and loaded with
``load_serving_bank``.  The port runs its ``cuda`` engine, whose wrappers
take the kernels' plain versions on CPU tensors.

Which JAX engine is the reference: the Pallas engine.  Its paged decode
is a plain f32 softmax over the dequantized K/V, which is what the TPU
runs and what the port's kernel computes; the ``ref`` engine's decode
truncates q, the logits, the probabilities and the output at four extra
sites and gives other tokens (ROADMAP queue 3).  At prefill the two JAX
engines agree, and the port is held against the ``ref`` engine there.

Tolerances: greedy tokens are equal.  Logits (bf16 at the GEMM boundary)
are compared per step by max and mean |difference| against the bounds
stated in each test, which come from payload codes flipping at RNE
boundaries (torch's log2/exp2 differ from XLA's in the last ulp; a flip is
one grid step of an 8-bit code).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.core import statsbank as jsb
from repro.core.policy import make_policy as jax_policy
from repro.launch import api
from repro.models import transformer as jtlm
from repro.serving import bank as jbank
from repro.serving.engine import PayloadLMServer as JaxServer
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core import statsbank as tsb
from repro_torch.core.policy import make_policy
from repro_torch.models import transformer as tlm
from repro_torch.serving import bank as tbank
from repro_torch.serving import paged_cache
from repro_torch.serving.engine import PayloadLMServer, Request
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]
LENGTHS, NEW_TOKENS, REQ_SEED = (5, 11), 6, 4
# the 12 keys a prefill-only probe mints on 2-layer minicpm: every key the
# frozen prefill and the payload pools' paged decode read (the f32 pools'
# decode attention reads two more, seg0:dense/qt0 and qt1)
PAGED_PATH_KEYS = {
    "embed/t0", "head/qt0", "seg0:dense/qf0",
    *(f"seg0:dense/attn/qt{i}" for i in range(4)),
    *(f"seg0:dense/mlp/qt{i}" for i in range(3)),
    "seg0:dense/kv_cache/t0", "seg0:dense/kv_cache/t1"}
EARLY_QKV = {f"seg0:dense/attn/qt{i}" for i in range(3)}
# the decode attention's two einsum sites, which only the decode probe
# visits
DECODE_EINSUMS = {"seg0:dense/qt0", "seg0:dense/qt1"}


def _jax_probes(params, cfg, pol):
    """``probe(tokens, passes, decode=False)``: the reference export's
    probe (serving/bank.py:61-122) on ``tokens`` [B, S].  Without
    ``decode``, the prefill graph alone: its ``init_bank``, then
    ``passes`` refreshes merged with ``merge_updates`` (refresh_every=1,
    ema_decay=0.5).  With ``decode``, the export's two graphs: the decode
    graph's ``init_bank`` merged in, and each pass's prefill refresh
    followed by a decode refresh (one ``decode_step`` at position S over
    the dense caches of a sessionless prefill, its argmax token), with one
    fix: each graph's refreshed states are merged only into the sites
    that graph visits (each step takes only those sites, which it alone
    reads).  The reference merges the other graph's zero cotangent too,
    which zeroes the prefill-only ``seg*/qf0`` (ROADMAP queue 3).  The
    refresh steps are jitted once, with the batch as an argument, for
    every probe of the module.  Returns (bank, [the prefill
    graph's keys, the decode graph's keys])."""
    probe_cfg = jsb.StatsConfig(refresh_every=1, ema_decay=0.5)

    def prefill_loss(p, b, pol_):
        logits, new_caches = jtlm.prefill(p, b["tokens"], cfg, pol_,
                                          b["caches"])
        loss = jnp.mean(logits.astype(jnp.float32) ** 2)
        return loss + 1e-30 * jbank._cache_term(new_caches), {}

    def decode_loss(p, b, pol_):
        logits, new_caches = jtlm.decode_step(p, b["token"], cfg, pol_,
                                              b["caches"], b["pos"])
        loss = jnp.mean(logits.astype(jnp.float32) ** 2)
        return loss + 1e-30 * jbank._cache_term(new_caches), {}

    def step_of(loss_fn):
        def run(p, bk, b):
            with jsb.bind(bk, 0, probe_cfg):
                loss, _ = loss_fn(p, b, pol)
            return loss
        return jax.jit(jax.value_and_grad(run, argnums=(0, 1)))

    steps = {"prefill": step_of(prefill_loss), "decode": step_of(decode_loss)}
    sessionless = jax.jit(lambda p, t, c: jtlm.prefill(p, t, cfg, pol, c))

    def probe(tokens, passes, decode=False):
        tokens = jnp.asarray(tokens, jnp.int32)
        b, s = tokens.shape
        fresh = jtlm.init_caches(cfg, b, s + 4, dtype=jnp.float32)
        graphs = [("prefill", prefill_loss,
                   {"tokens": tokens, "caches": fresh})]
        if decode:
            logits, filled = sessionless(params, tokens, fresh)
            graphs.append(("decode", decode_loss, {
                "token": jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(
                    jnp.int32),
                "caches": filled, "pos": jnp.full((b,), s, jnp.int32)}))
        visited = [jsb.init_bank(f, params, bt, pol, probe_cfg)
                   for _, f, bt in graphs]
        bank = {k: v for keys in visited for k, v in keys.items()}
        for _ in range(passes):
            for (name, _, bt), keys in zip(graphs, visited):
                own = {k: bank[k] for k in keys}
                _, (_, updates) = steps[name](params, own, bt)
                bank = {**bank, **jsb.merge_updates(own, updates)}
        return jax.device_get(bank), [set(keys) for keys in visited]

    return probe


@pytest.fixture(scope="module")
def jax_side():
    cfg = jax_reduced_config("minicpm_2b").replace(n_layers=2, remat=False)
    params = api.init_params(cfg, jax.random.PRNGKey(0))
    ref_pol = jax_policy("s2fp8", backend="ref", gemm_mode="payload")
    export = jax.device_get(jbank.export_serving_bank(
        params, cfg, ref_pol, prompt_len=8, batch=2, passes=1))
    calib_tokens = np.random.default_rng(11).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32)
    probe = _jax_probes(params, cfg, ref_pol)
    prefill_probe, _ = probe(calib_tokens, 2)
    # export_serving_bank's own probe prompts, drawn as it draws them
    export_tokens = np.array(jax.random.randint(
        jax.random.PRNGKey(0), (2, 8), 0, cfg.vocab, jnp.int32))
    fixed, visited = probe(export_tokens, 1, decode=True)
    return {"cfg": cfg, "params": params, "ref_pol": ref_pol,
            "banks": {"export": export, "prefill_probe": prefill_probe},
            "calib_tokens": calib_tokens, "export_tokens": export_tokens,
            "fixed_export": fixed, "visited": visited,
            "export_prefill_probe": probe(export_tokens, 1)[0]}


@pytest.fixture(scope="module")
def port_side(jax_side):
    cfg = get_reduced_config("minicpm_2b").replace(n_layers=2)
    params = params_from_jax(jax.device_get(jax_side["params"]),
                             device="cpu")
    banks = {k: tbank.load_serving_bank(v, device="cpu")
             for k, v in jax_side["banks"].items()}
    return {"cfg": cfg, "params": params, "banks": banks,
            "pol": make_policy("s2fp8")}


def _requests(cls, vocab, lengths=LENGTHS, new_tokens=NEW_TOKENS,
              seed=REQ_SEED):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, vocab, int(n), dtype=np.int32),
                max_new_tokens=new_tokens) for n in lengths]


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _record_logits(server, store, choices=None):
    """Wrap a server's prefill/decode so every step's logits of live rows
    are kept: admitted prompts at prefill (dummy rows are all-zero token
    rows), live slots at decode.  Dummy rows and dead slots compute
    discarded garbage.  With ``choices`` (one array of live rows' tokens a
    step; a port server), each step then takes its next tokens from them
    instead of its own argmax: teacher forcing."""
    prefill, decode = server._prefill, server._decode
    it = None if choices is None else iter(choices)

    def keep(out, live, kind):
        store.append((kind, _as_np(out[0])[live]))
        if it is None:
            return out
        forced = torch.zeros(out[0].shape, dtype=torch.float32)
        forced[np.flatnonzero(live), -1, torch.as_tensor(next(it))] = 1.0
        return forced, out[1]

    def p(params, tokens, last_index):
        out = prefill(params, tokens, last_index)
        return keep(out, np.any(_as_np(tokens) != 0, axis=1), "prefill")

    def d(*a):
        live = np.array([r is not None for r in server.slot_req])
        return keep(decode(*a), live, "decode")

    server._prefill, server._decode = p, d


def _serve(server, reqs):
    for r in reqs:
        server.submit(r)
    server.run_to_completion(max_ticks=200)
    return [r.out for r in reqs]


@pytest.fixture(scope="module")
def jax_pallas_run(jax_side):
    """The JAX Pallas engine (interpret mode) on the exported bank: tokens
    and per-step logits of live rows."""
    cfg = jax_side["cfg"]
    pol = jax_policy("s2fp8", backend="pallas", gemm_mode="payload")
    srv = JaxServer(cfg, jax_side["params"], pol,
                    bank=jax_side["banks"]["export"], slots=2, max_len=96,
                    block=8, cache_fmt="e5m2")
    steps = []
    _record_logits(srv, steps)
    return _serve(srv, _requests(JaxRequest, cfg.vocab)), steps


def test_params_from_jax_keeps_tree_and_layout(jax_side, port_side):
    jp, tp = jax.device_get(jax_side["params"]), port_side["params"]
    assert set(tp) == set(jp) and len(tp["segments"]) == 1
    seg_j, seg_t = jp["segments"][0], tp["segments"][0]
    assert set(seg_t) == set(seg_j) and set(seg_t["mlp"]) == set(seg_j["mlp"])
    for name in ("wq", "wk", "wv", "wo"):
        assert tuple(seg_t[name].shape) == seg_j[name].shape
        np.testing.assert_array_equal(seg_t[name].numpy(), seg_j[name])
    assert tuple(seg_t["wq"].shape) == (2, 128, 128)        # [L, d_in, d_out]
    np.testing.assert_array_equal(tp["embed"].numpy(), jp["embed"])
    assert tp["embed"].dtype == torch.float32


def test_load_serving_bank_keeps_keys_and_values(jax_side, port_side):
    jb = jax_side["banks"]["export"]
    tb = port_side["banks"]["export"]
    assert set(tb) == set(jb)
    for key, entry in jb.items():
        assert set(tb[key]) == set(entry)
        for direction, state in entry.items():
            for field, value in state.items():
                np.testing.assert_array_equal(
                    tb[key][direction][field].numpy(), np.asarray(value))
    assert tuple(tb["seg0:dense/attn/qt0"]["a.fwd"]["alpha"].shape) == (2,)


@pytest.mark.parametrize("bank_name", ["export", "prefill_probe"])
def test_prefill_logits_match_jax_ref_engine(jax_side, port_side, bank_name):
    """Batched prefill with per-row last indices, frozen bank, vs the JAX
    ref engine (which agrees bit for bit with the JAX Pallas engine at
    prefill).  Logits have mean |x| ~0.18.  Bounds: max |diff| <= 0.1 and
    mean <= 0.02 with the calibrated prefill-probe bank (measured 0.045 /
    0.009: payload codes that flip on last-ulp log2/exp2 noise — XLA
    computes log2 as log * 1/ln2 with the stats folded in — move a GEMM
    output, and the difference spreads through bf16 rounding and the next
    layer's quantization); max <= 0.2 and mean <= 0.04 with the exported
    bank (measured 0.085 / 0.020: its qf0 site freezes to alpha=1, beta=15,
    ROADMAP queue 3, which puts bf16 inputs exactly on RNE ties, so ~1% of
    Q/K/V codes flip on the same noise)."""
    cfg, tcfg = jax_side["cfg"], port_side["cfg"]
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (3, 16)
                                             ).astype(np.int32)
    last = np.array([15, 6, 10], np.int32)
    bank = jax_side["banks"][bank_name]
    with jsb.freeze(bank):
        jl, _ = jax.jit(lambda p, t, c, li: jtlm.prefill(
            p, t, cfg, jax_side["ref_pol"], c, last_index=li))(
            jax_side["params"], jnp.asarray(toks),
            jtlm.init_caches(cfg, 3, 16, dtype=jnp.float32),
            jnp.asarray(last))
    with torch.no_grad(), tsb.freeze(port_side["banks"][bank_name]):
        tl, caches = tlm.prefill(port_side["params"],
                                 torch.from_numpy(toks).long(), tcfg,
                                 port_side["pol"],
                                 tlm.init_caches(tcfg, 3, 16, device="cpu"),
                                 last_index=torch.from_numpy(last))
    assert tl.shape == (3, 1, cfg.vocab) and tl.dtype == torch.bfloat16
    d = np.abs(tl.float().numpy() - np.asarray(jl.astype(jnp.float32)))
    lim = (0.2, 0.04) if bank_name == "export" else (0.1, 0.02)
    assert d.max() <= lim[0] and d.mean() <= lim[1], (d.max(), d.mean())
    assert torch.isfinite(caches[0]["k"]).all()


def test_greedy_tokens_and_logits_match_jax_pallas_engine(
        jax_pallas_run, port_side):
    """The request mix of ROADMAP queue 3's engine record (prompts of 5 and
    11 tokens, 6 new tokens each, 2 slots, block 8, e5m2 pool) through the
    port's PayloadLMServer and the JAX Pallas engine in interpret mode,
    sharing the exported bank: the same greedy tokens, and per-step logits
    of live rows (mean |logit| ~0.18) within max |diff| <= 0.15, mean <=
    0.035 at prefill and max <= 0.08, mean <= 0.015 at decode (measured:
    prefill 0.121 / 0.027, decode 0.055 / 0.012, the same with one XLA
    thread; the reasons are the prefill test's)."""
    jtoks, jsteps = jax_pallas_run
    cfg = port_side["cfg"]
    srv = PayloadLMServer(cfg, port_side["params"], port_side["pol"],
                          bank=port_side["banks"]["export"], slots=2,
                          max_len=96, block=8, cache_fmt="e5m2")
    steps = []
    _record_logits(srv, steps)
    toks = _serve(srv, _requests(Request, cfg.vocab))
    assert toks == jtoks
    assert [k for k, _ in steps] == [k for k, _ in jsteps]
    lim = {"prefill": (0.15, 0.035), "decode": (0.08, 0.015)}
    for (kind, t), (_, j) in zip(steps, jsteps):
        d = np.abs(t - j)
        assert np.isfinite(t).all()
        assert d.max() <= lim[kind][0] and d.mean() <= lim[kind][1], (
            kind, d.max(), d.mean())


def test_batched_admission_bounded_prefill_shapes(port_side):
    cfg = port_side["cfg"]
    srv = PayloadLMServer(cfg, port_side["params"], port_side["pol"],
                          bank=port_side["banks"]["prefill_probe"], slots=4,
                          max_len=64, block=8, cache_fmt="e5m2")
    reqs = _requests(Request, cfg.vocab, (3, 5, 9, 12, 17, 30, 6, 11), 3, 3)
    _serve(srv, reqs)
    assert all(len(r.out) == 3 for r in reqs)
    assert len(srv.prefill_shapes) <= srv.max_prefill_shapes
    assert {p for _, p in srv.prefill_shapes} <= {8, 16, 32}


def test_preemption_under_pool_pressure(port_side):
    cfg = port_side["cfg"]
    srv = PayloadLMServer(cfg, port_side["params"], port_side["pol"],
                          bank=port_side["banks"]["prefill_probe"], slots=2,
                          max_len=32, block=8, n_blocks=5, cache_fmt="e5m2")
    reqs = _requests(Request, cfg.vocab, (9, 9, 9), 20, 5)
    for r in reqs:
        srv.submit(r)
    ticks = srv.run_to_completion(max_ticks=500)
    assert ticks < 500 and srv.preemptions > 0
    assert all(len(r.out) == 20 for r in reqs)


def test_prefill_token_budget_defers_admission(port_side):
    cfg = port_side["cfg"]
    srv = PayloadLMServer(cfg, port_side["params"], port_side["pol"],
                          bank=port_side["banks"]["prefill_probe"], slots=4,
                          max_len=32, block=8, cache_fmt="e5m2",
                          prefill_token_budget=16)
    reqs = _requests(Request, cfg.vocab, (9, 9, 9, 9), 4, 6)
    for r in reqs:
        srv.submit(r)
    srv.step()
    assert sum(r is not None for r in srv.slot_req) == 1
    assert len(srv.queue) == 3
    srv.run_to_completion(max_ticks=100)
    assert all(len(r.out) == 4 for r in reqs)


@pytest.mark.parametrize("cache_fmt", ["e5m2", "e4m3"])
def test_pool_is_one_byte_per_element(port_side, cache_fmt):
    cfg = port_side["cfg"]
    srv = PayloadLMServer(cfg, port_side["params"], port_side["pol"],
                          bank=port_side["banks"]["prefill_probe"], slots=2,
                          max_len=32, block=8, cache_fmt=cache_fmt)
    for seg in srv.caches:
        assert seg["kp"].element_size() == 1 and seg["vp"].element_size() == 1
    pool_b, stats_b = srv.cache_bytes()
    assert pool_b == sum(s["kp"].numel() + s["vp"].numel()
                         for s in srv.caches)
    assert stats_b == sum(s["kab"].numel() + s["vab"].numel()
                          for s in srv.caches) * 4
    reqs = _requests(Request, cfg.vocab, (7, 12), 5, 8)
    _serve(srv, reqs)
    assert all(len(r.out) == 5 for r in reqs)


def _assert_fwd_close(got, want, msg, tight=False, row_rtol=None):
    """Forward-state fields of one site direction: within 1e-4 relative
    with ``tight``; else alpha, beta and ema_mu within 5e-2 relative and
    ema_m within 0.25 (log2 units), and with ``row_rtol`` (row -> rtol)
    those rows' alpha, beta and ema_mu within their own bound."""
    for field in ("alpha", "beta", "ema_mu", "ema_m", "last"):
        g = got[field].numpy()
        w = np.asarray(want[field])
        assert g.shape == w.shape, (msg, field)
        m = f"{msg} {field}"
        if tight:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=m)
            continue
        if field == "ema_m":
            np.testing.assert_allclose(g, w, atol=0.25, err_msg=m)
            continue
        rows = row_rtol or {}
        for row in range(g.shape[0]) if rows else [...]:
            np.testing.assert_allclose(g[row], w[row],
                                       rtol=rows.get(row, 5e-2), atol=1e-5,
                                       err_msg=f"{m} row {row}")


def test_calibrate_matches_jax_prefill_probe(jax_side, port_side):
    """calibrate_serving_bank on the same tokens mints every key of the
    JAX prefill-only probe (every key the frozen prefill and the paged
    decode read) and the decode attention's two einsum sites; where the
    decode probe leaves a site's state as prefill made it, that state
    agrees with the JAX probe's: within 1e-4 relative for the tensors
    that do not depend on an earlier payload GEMM, the weights (every
    b.fwd, which the decode probe refreshes from the same tensor) and the
    embedding table (the f32 reductions run in another order; measured <=
    2e-6); alpha, beta and ema_mu within 5e-2 relative and ema_m within
    0.25 (log2 units) for the flash site ``seg0:dense/qf0``, which only
    prefill visits (measured 3.5e-2 and 3.3e-2: payload codes that flip on
    last-ulp log2/exp2 noise change what later sites see).  The sites both
    graphs refresh are held against the export's algorithm in
    ``test_calibrate_matches_jax_export``.  Cotangent states are not
    calibrated."""
    tokens = torch.from_numpy(jax_side["calib_tokens"]).long()
    bank = tbank.calibrate_serving_bank(
        port_side["params"], port_side["cfg"], port_side["pol"], tokens,
        passes=2)
    ref = jax_side["banks"]["prefill_probe"]
    assert set(ref) == PAGED_PATH_KEYS
    assert set(bank) == PAGED_PATH_KEYS | DECODE_EINSUMS == set(
        jax_side["banks"]["export"])
    for key, entry in ref.items():
        assert set(bank[key]) == set(entry)
        for direction, state in entry.items():
            weight = direction == "b.fwd" or key == "embed/t0"
            if direction.endswith("fwd") and (weight
                                              or key == "seg0:dense/qf0"):
                _assert_fwd_close(bank[key][direction], state,
                                  f"{key} {direction}", tight=weight)
    # the calibrated bank serves prefill and paged decode with no key
    # missing
    srv = PayloadLMServer(port_side["cfg"], port_side["params"],
                          port_side["pol"], bank=bank, slots=2, max_len=32,
                          block=8)
    reqs = _requests(Request, port_side["cfg"].vocab, (6,), 3, 9)
    _serve(srv, reqs)
    assert len(reqs[0].out) == 3


def test_calibrate_matches_jax_export(jax_side, port_side):
    """calibrate_serving_bank on the export's probe prompts (one pass:
    prefill, then the decode probe) mints every key of the reference's
    export (the two graphs' ``init_bank`` keys) and its forward states
    agree with the export's probe, its merge fault fixed: within 1e-4
    relative for every weight (the b.fwd of every site but the decode
    einsums', whose b is the K or V cache), the embedding table and layer
    0's Q/K/V; alpha, beta and ema_mu within 5e-2 relative and ema_m
    within 0.25 everywhere else outside layer 1 (measured 2.0e-2 and
    0.07), and in layer 1's rows of the sites the decode probe refreshes
    (every site but ``qf0``) alpha, beta and ema_mu within 1e-1
    (measured 7.5e-2): layer 1's decode-probe tensors (one token a row,
    256 elements) follow code flips of layer 0's decode attention.  The
    prefill-only ``seg0:dense/qf0``, which the export zeroes (ROADMAP
    queue 3), is held against the prefill-only probe: the fixed probe's
    is that probe's, bit for bit."""
    tokens = torch.from_numpy(jax_side["export_tokens"]).long()
    bank = tbank.calibrate_serving_bank(
        port_side["params"], port_side["cfg"], port_side["pol"], tokens,
        passes=1)
    ref, export = jax_side["fixed_export"], jax_side["banks"]["export"]
    prefill_keys, decode_keys = jax_side["visited"]
    assert set(bank) == set(ref) == set(export) == prefill_keys | decode_keys
    assert decode_keys - prefill_keys == DECODE_EINSUMS
    assert prefill_keys - decode_keys == {"seg0:dense/qf0"}
    qf0 = "seg0:dense/qf0"
    alone = jax_side["export_prefill_probe"][qf0]
    for direction, state in ref[qf0].items():
        for field, v in state.items():
            np.testing.assert_array_equal(v, alone[direction][field])
            if direction.endswith("fwd"):
                assert not np.any(export[qf0][direction][field])
    for key, entry in ref.items():
        assert set(bank[key]) == set(entry)
        layer1 = {} if key == qf0 or not key.startswith("seg") else {1: 1e-1}
        for direction, state in entry.items():
            if not direction.endswith("fwd"):
                continue
            msg = f"{key} {direction}"
            weight = direction == "b.fwd" and key not in DECODE_EINSUMS
            if weight or key == "embed/t0":
                _assert_fwd_close(bank[key][direction], state, msg,
                                  tight=True)
                continue
            if key in EARLY_QKV:
                _assert_fwd_close({f: v[:1] for f, v in
                                   bank[key][direction].items()},
                                  {f: np.asarray(v)[:1] for f, v in
                                   state.items()}, f"{msg} layer 0",
                                  tight=True)
            _assert_fwd_close(bank[key][direction], state, msg,
                              row_rtol=layer1)


def test_port_imports_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.MULTILINE)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 20
    # the training slices' modules are scanned too
    assert {"trainer.py", "train.py", "optimizers.py", "schedules.py",
            "synthetic.py", "deepseek_moe_16b.py"} <= {f.name for f in files}
    # and the resilient loop's: obs/, checkpoint/, guard, chaos, fault
    assert {"sinks.py", "metrics.py", "telemetry.py", "doctor.py",
            "manager.py", "guard.py", "chaos.py", "fault.py"} <= {
        f.name for f in files}
    # and the launchers' model API
    assert "api.py" in {f.name for f in files}
    # and the dry run, the cost counter, the doctor and the examples
    assert {"dryrun.py", "trace_cost.py", "analysis.py", "quickstart.py",
            "serve_lm.py", "train_100m_e2e.py"} <= {f.name for f in files}
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert offenders == []


def test_entry_points_need_cuda_unless_cpu_is_asked(jax_side, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced_config("minicpm_2b").replace(n_layers=1)
    tree = jax.device_get(jax_side["params"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_lm(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(tree)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbank.load_serving_bank(jax_side["banks"]["export"])
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "minicpm_2b", "--reduced"])
    params = tlm.init_lm(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert params_from_jax(tree, device="cpu")["embed"].device.type == "cpu"


def test_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "minicpm_2b", "--reduced", "--device", "cpu",
                "--requests", "3", "--slots", "2",
                "--max-len", "32", "--prompt-len", "6", "--new-tokens", "3",
                "--calib-passes", "1"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out


def test_paged_cache_rejects_unported_formats(port_side):
    """A format outside the reference's five is refused; the five are
    taken."""
    kw = dict(slots=1, n_blocks=2, block=8, max_blocks=1, kv_stats=None,
              device="cpu")
    with pytest.raises(ValueError, match="cache format"):
        paged_cache.init_paged_caches(port_side["cfg"], cache_fmt="bf16",
                                      **kw)
    for fmt in paged_cache.CACHE_FMTS:
        caches = paged_cache.init_paged_caches(port_side["cfg"],
                                               cache_fmt=fmt, **kw)
        assert caches[0]["kp"].dtype == paged_cache.pool_dtype(fmt)


def test_serve_launcher_takes_the_reference_flag_name():
    """``--export-passes`` (the reference's name, serve.py:47) and the
    port's ``--calib-passes`` set the same value; the default is 2."""
    from repro_torch.launch import serve
    ap = serve.build_parser()
    base = ["--arch", "minicpm_2b"]
    assert ap.parse_args(base + ["--export-passes", "3"]).export_passes == 3
    assert ap.parse_args(base + ["--calib-passes", "3"]).export_passes == 3
    assert ap.parse_args(base).export_passes == 2
