"""The port's Mamba-2 path (zamba2_1p2b) against the JAX package, on the CPU.

Reduced zamba2_1p2b: 4 layers ``mamba2, mamba2, attn, mamba2``, d 128, di
256 = 8 heads of 32 channels, 8 states, 4 attention heads of 32, GELU-GLU,
vocab 512.  Params are made by ``repro.launch.api.init_params`` and carried
across with ``params_from_jax``; inputs are made with numpy from a seed.
The JAX side runs jitted; its policies name the engine and the GEMM mode
(``ref``, payload), the port's the plain engine and payload (or the
``cuda_fused`` engine's plain versions on the CPU, as the serving engine
uses it).  The port runs every ``ssm_impl`` schedule as its scan; the
reference's "step" (``lax.scan`` of one step) and "ssd" (``_ssd_chunked``,
chunks of 64) are each held against it.  Tolerances are stated beside each
comparison.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced_config
from repro.core.policy import make_policy as jax_policy
from repro.launch import api
from repro.models import blocks as jblocks
from repro.models import transformer as jtlm
from repro.serving.engine import LMServer as JaxLMServer
from repro.serving.engine import Request as JaxRequest
from repro_torch import kernels
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import make_policy
from repro_torch.kernels import selective_scan as tscan
from repro_torch.models import blocks as tblocks
from repro_torch.models import transformer as tlm
from repro_torch.serving.engine import LMServer, PayloadLMServer, Request
from ssm_parity import head_inputs, jax_ssd_scan, jax_step_scan
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

ARCH = "zamba2_1p2b"


def _pols(mode):
    if mode == "fp32":
        return jax_policy("fp32"), make_policy("fp32")
    return (jax_policy(mode, backend="ref", gemm_mode="payload"),
            make_policy(mode, "plain", "payload"))


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(api.init_params(jax_reduced_config(ARCH),
                                          jax.random.PRNGKey(0)))


@pytest.mark.parametrize("schedule", ["step", "ssd"])
@pytest.mark.parametrize("shape", [(2, 64, 8, 32, 8), (1, 128, 4, 64, 64)])
def test_heads_scan_plain_vs_reference(shape, schedule):
    """``selective_scan_plain`` on per-head inputs (the reduced config's 8
    heads of 32 with 8 states, and zamba2's head dim 64 with 64 states)
    against the reference's two schedules: y and the final state within
    rtol 1e-4, atol 1e-5 (the reference's tolerance for its scan kernel
    against the oracle; the state update rounds its products in another
    order, and "ssd" sums each chunk as products of cumulated decays)."""
    b, s, nh, hd, n = shape
    args = head_inputs(b, s, nh, hd, n)
    fn = jax_step_scan if schedule == "step" else jax_ssd_scan
    yj, hj = jax.jit(fn)(*(jnp.asarray(t) for t in args))
    kernels.reset_counts()
    yp, hp = tscan.selective_scan(*(torch.from_numpy(t) for t in args))
    assert kernels.counts()["selective_scan"] == {"launches": 0,
                                                  "plain_calls": 1}
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(hp.numpy().reshape(b, nh, hd, n),
                               np.asarray(hj), rtol=1e-4, atol=1e-5)


def test_heads_scan_checks_shapes():
    x, dt, bm, cm, a, d = (torch.from_numpy(t) for t in
                           head_inputs(1, 4, 4, 8, 2))
    with pytest.raises(ValueError, match="per-head"):
        tscan.selective_scan(x, dt[..., :3], bm, cm, a, d)
    with pytest.raises(ValueError, match="per-head"):
        tscan.selective_scan(x[..., :31], dt[..., :3], bm, cm, a[:3], d[:3])


def _layer(jax_params, i):
    """Layer 0 of segment ``i`` as JAX arrays and as port tensors."""
    lp = jax.tree_util.tree_map(lambda v: np.asarray(v[0]),
                                jax_params["segments"][i])
    return lp, params_from_jax(lp, device="cpu")


@pytest.mark.parametrize("schedule", ["step", "ssd"])
@pytest.mark.parametrize("mode", ["fp32", "s2fp8"])
def test_mamba2_block_prefill_and_decode_vs_reference(jax_params, mode,
                                                      schedule):
    """One mamba2 block (layer 0), prefill of 64 tokens (a multiple of
    "ssd"'s chunk) into an f32 cache, as LMServer's, and one decode step
    from it, against ``blocks.mamba2_apply``.  The conv windows are the
    same bits (copies of bf16 values).  The input norm and the in
    projection round to bf16 after sums in XLA's order on one side and
    torch's on the other: 0.1% of the projection's outputs differ by one
    bf16 ulp (measured), and they feed the conv, the scan and the gate.
    The block output is the bf16 sum of the input and the block's update,
    so bounds are in units of |output| + |update|: every output within
    2^-4 of it and at most 2% of the outputs not bit-equal (measured: fp32
    0.0255 and 1.0%, s2fp8 0.040 and 0.02%).  The SSM state: fp32 within
    1e-3 of its largest entry at most and 1e-5 on average (measured 3.3e-4
    and 6.8e-7: the projection's flips); s2fp8 (payload GEMMs, exact
    stats) within 2e-2 at most and 1e-3 on average (the two sides' stats
    differ in their last bits, which moves dt, B and C by f32 ulps with no
    bf16 rounding to absorb them; measured 2.4e-7).  "ssd" sums each chunk
    as products of cumulated decays; its readings are the same."""
    cfg_j = jax_reduced_config(ARCH).replace(ssm_impl=schedule)
    cfg = get_reduced_config(ARCH).replace(ssm_impl=schedule)
    jp, tp = _pols(mode)
    lp, lpt = _layer(jax_params, 0)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)

    step = jax.jit(lambda p, x, c, m: jblocks.mamba2_apply(
        p, x, cfg_j, jp, c, m)[:2], static_argnums=3)
    cj = jblocks.init_cache("mamba2", cfg_j, 2, 80, dtype=jnp.float32)
    yj, cj = step(lp, jnp.asarray(x, jnp.bfloat16), cj, "prefill")
    yj1, cj1 = step(lp, jnp.asarray(x1, jnp.bfloat16), cj, "decode")

    ct = tblocks.init_cache("mamba2", cfg, 2, 80)
    with torch.no_grad():
        yt, _, aux = tblocks.mamba2_apply(
            lpt, torch.from_numpy(x).bfloat16(), cfg, tp, ct, "prefill")
        ct0 = {k: v.clone() for k, v in ct.items()}
        yt1, _, _ = tblocks.mamba2_apply(
            lpt, torch.from_numpy(x1).bfloat16(), cfg, tp, ct, "decode")
    assert yt.dtype == torch.bfloat16 and float(aux) == 0.0
    assert ct["conv"].dtype == torch.float32
    assert ct["conv"].shape == (2, 3, 256 + 2 * 8)
    assert ct["ssm"].shape == (2, 8, 32, 8)
    for cache_j, cache_t, y_j, y_t, x_in in ((cj, ct0, yj, yt, x),
                                             (cj1, ct, yj1, yt1, x1)):
        y_j = np.asarray(y_j, np.float32)
        x_in = np.asarray(jnp.asarray(x_in, jnp.bfloat16), np.float32)
        diff = np.abs(y_t.float().numpy() - y_j)
        assert (diff <= 2.0 ** -4 * (np.abs(y_j) + np.abs(y_j - x_in))
                + 1e-6).all()
        assert (diff > 0).mean() <= 0.02
        np.testing.assert_array_equal(cache_t["conv"].numpy(),
                                      np.asarray(cache_j["conv"]))
        hj, ht = np.asarray(cache_j["ssm"]), cache_t["ssm"].numpy()
        top, err = np.abs(hj).max(), np.abs(ht - hj)
        if mode == "fp32":
            assert err.max() <= 1e-3 * top and err.mean() <= 1e-5 * top
        else:
            assert err.max() <= 2e-2 * top and err.mean() <= 1e-3 * top


@pytest.mark.parametrize("schedule", ["step", "ssd"])
def test_mamba2_block_train_gradients_vs_jax_grad(jax_params, schedule):
    """A mamba2 block in ``mode="train"`` (fp32, f32 input of 64 tokens):
    the output within rtol 1e-4, and the gradients of a fixed projection
    of it with respect to the input and every leaf against ``jax.grad``
    of the reference's block within rtol 2e-3, atol 2e-4 of each leaf's
    largest entry (tests/test_hillclimb_equivalence.py's tolerance
    between the reference's schedules)."""
    cfg_j = jax_reduced_config(ARCH).replace(ssm_impl=schedule)
    cfg = get_reduced_config(ARCH).replace(ssm_impl=schedule)
    pol_j, pol_t = _pols("fp32")
    lp, lpt = _layer(jax_params, 0)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y = jblocks.mamba2_apply(p, x, cfg_j, pol_j, None, "train")[0]
        return jnp.sum(y * w), y

    (_, yj), (gpj, gxj) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(lp, jnp.asarray(x))

    leaves = {k: v for k, v in lpt.items() if k != "ln"}
    leaves["ln/scale"] = lpt["ln"]["scale"]
    for v in leaves.values():
        v.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = tblocks.mamba2_apply(lpt, xt, cfg, pol_t, None, "train")[0]
    grads = torch.autograd.grad((yt * torch.from_numpy(w)).sum(),
                                [xt] + list(leaves.values()))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=1e-4, atol=1e-5)
    want = [np.asarray(gxj)] + [
        np.asarray(gpj["ln"]["scale"] if k == "ln/scale" else gpj[k])
        for k in leaves]
    for name, g, wj in zip(["x"] + list(leaves), grads, want):
        top = np.abs(wj).max()
        np.testing.assert_allclose(g.numpy(), wj, rtol=2e-3,
                                   atol=2e-4 * top, err_msg=name)


def test_prefill_then_decode_matches_full_forward():
    """prefill(S tokens) + decode(1) against a prefill of the S + 1 tokens
    without a cache (f32 activations, fp32 policy), the tolerances of
    tests/test_models_smoke.py's ``test_prefill_decode_consistency``: 1e-4
    at prefill, 1e-3 after the decode step.  Reduced zamba2's attention
    block decodes against its dense cache between the mamba2 blocks."""
    cfg = get_reduced_config(ARCH).replace(activation_dtype="float32")
    pol = make_policy("fp32")
    params = tlm.init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)))
    caches = tlm.init_caches(cfg, 2, 24)
    with torch.no_grad():
        logits_p, caches = tlm.prefill(params, toks, cfg, pol, caches)
        full, _ = tlm.prefill(params, toks, cfg, pol, None)
        np.testing.assert_allclose(logits_p.numpy(), full.numpy(),
                                   rtol=1e-4, atol=1e-4)
        nxt = logits_p.argmax(-1)
        logits_d, _ = tlm.decode_step(params, nxt, cfg, pol, caches,
                                      torch.full((2,), 12))
        full2, _ = tlm.prefill(params, torch.cat([toks, nxt], 1), cfg, pol,
                               None)
    np.testing.assert_allclose(logits_d.numpy(), full2.numpy(), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("get_jax,get_port", [
    (jax_config, get_config), (jax_reduced_config, get_reduced_config)])
def test_n_params_and_config_match_reference(get_jax, get_port):
    cfg_j, cfg = get_jax(ARCH), get_port(ARCH)
    assert cfg.n_params() == cfg_j.n_params()
    for field in ("name", "family", "n_layers", "d_model", "n_heads",
                  "kv_heads", "d_ff", "vocab", "head_dim", "activation",
                  "norm", "pattern", "tie_embeddings", "ssm_impl"):
        assert getattr(cfg, field) == getattr(cfg_j, field), field
    assert dict(vars(cfg.ssm)) == dict(vars(cfg_j.ssm))
    if get_port is get_config:
        assert cfg.n_params() == 1_352_138_752
        assert cfg.resolved_pattern.count("mamba2") == 32
        assert cfg.resolved_pattern.count("attn") == 6
    else:
        assert cfg.pattern == ("mamba2", "mamba2", "attn", "mamba2")


def test_convert_carries_the_mamba2_leaves(jax_params):
    """Every leaf of the JAX tree arrives under its name, in its layout,
    with its values; the port's own ``init_lm`` makes the same tree, and
    its deterministic leaves (A's log, dt's bias, D, the conv bias, the
    norm scales) within 1e-6 relative."""
    tree = params_from_jax(jax_params, device="cpu")
    seg_j, seg_t = jax_params["segments"][0], tree["segments"][0]
    leaves = {"ln", "w_in", "conv_w", "conv_b", "a_log", "dt_bias",
              "d_skip", "norm_scale", "w_out"}
    assert set(seg_t) == set(seg_j) == leaves
    assert seg_t["w_in"].shape == (2, 128, 2 * 256 + 2 * 8 + 8)
    assert seg_t["conv_w"].shape == (2, 4, 256 + 2 * 8)
    for name in leaves - {"ln"}:
        np.testing.assert_array_equal(seg_t[name].numpy(),
                                      np.asarray(seg_j[name]))
    own = tlm.init_lm(get_reduced_config(ARCH), seed=0, device="cpu")
    flat_own = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: tuple(t.shape), own,
                               is_leaf=torch.is_tensor))
    flat_jax = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda a: tuple(a.shape), jax_params))
    assert [(str(p), s) for p, s in flat_own] == \
        [(str(p), s) for p, s in flat_jax]
    for name in ("a_log", "dt_bias", "d_skip", "conv_b", "norm_scale"):
        np.testing.assert_allclose(own["segments"][0][name].numpy(),
                                   np.asarray(seg_j[name]), rtol=1e-6)


# -- serving: the port's dense-cache LMServer against the JAX LMServer ----

LENGTHS, NEW_TOKENS, SLOTS, MAX_LEN = (5, 8, 3, 11, 6), (6, 4, 6, 3, 5), 3, 32


def _jax_serve(server, prompts):
    """The JAX server's tokens and, per prefill or decode call, the logits
    of its live rows (prompt rows at prefill, live slots at decode)."""
    steps = []
    prefill, decode = server._prefill, server._decode

    def p(*args):
        out = prefill(*args)
        live = np.any(np.asarray(args[1]) != 0, axis=1)
        steps.append(np.asarray(out[0][:, -1], np.float32)[live])
        return out

    def d(*args):
        live = np.array([r is not None for r in server.slot_req])
        out = decode(*args)
        steps.append(np.asarray(out[0][:, -1], np.float32)[live])
        return out

    server._prefill, server._decode = p, d
    reqs = [JaxRequest(prompt=q, max_new_tokens=k)
            for q, k in zip(prompts, NEW_TOKENS)]
    for r in reqs:
        server.submit(r)
    server.run_to_completion()
    return [r.out for r in reqs], steps


def _port_serve_forced(server, prompts, choices):
    """The port's server teacher-forced along ``choices`` (per call, the
    tokens of its live rows): the logits of its live rows per call."""
    steps, it = [], iter(choices)
    prefill, decode = server._prefill, server._decode

    def force(out, live):
        steps.append(out[0][:, -1].float().numpy()[live])
        forced = torch.zeros(out[0].shape, dtype=torch.float32)
        forced[np.flatnonzero(live), -1, torch.as_tensor(next(it)).long()] \
            = 1.0
        return forced, out[1]

    def p(params, tokens, last):
        return force(prefill(params, tokens, last),
                     (tokens != 0).any(dim=1).numpy())

    def d(*args):
        live = np.array([r is not None for r in server.slot_req])
        return force(decode(*args), live)

    server._prefill, server._decode = p, d
    reqs = [Request(prompt=q, max_new_tokens=k)
            for q, k in zip(prompts, NEW_TOKENS)]
    for r in reqs:
        server.submit(r)
    server.run_to_completion()
    return [r.out for r in reqs], steps


# (largest, mean) |port - JAX| logit per call over the forced run
SERVE_BOUNDS = {"fp32": (0.05, 0.01), "s2fp8": (0.4, 0.1)}


@pytest.mark.parametrize("mode", ["fp32", "s2fp8"])
def test_lmserver_serves_zamba2_as_the_reference(jax_params, mode):
    """Five requests of 3-11 tokens on 3 slots (admissions while other
    slots decode; four prompts padded to their bucket) through the port's
    LMServer, teacher-forced along the JAX LMServer's greedy tokens
    (reduced models' logits are flat, so near ties decide free-running
    tokens: ROADMAP queue 3), the same params.  fp32 and s2fp8 with exact
    per-call stats and payload GEMMs (the JAX ``ref`` engine, the port's
    ``cuda_fused`` engine on its plain versions).  Bounds on every call's
    live-row logits (mean |logit| about 0.8): fp32 max 0.05, mean 0.01
    (the scan's and the bf16 GEMMs' sums run in other orders, which moves
    a bf16 rounding of a hidden state now and then; measured 0.035 and
    0.0056, and the free-running tokens part at a near tie); s2fp8 max
    0.4, mean 0.1, about twice the measured 0.197 and 0.046 (the two
    sides' stats differ in their last bits and the SSM state carries the
    moves, as tests/test_torch_dense_serving.py finds for mamba1).  The
    forced run gives JAX's tokens, and the first prefill call's own
    greedy tokens, which no forcing reaches, are JAX's."""
    cfg_j, cfg = jax_reduced_config(ARCH), get_reduced_config(ARCH)
    params = params_from_jax(jax_params, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, n, dtype=np.int32) for n in LENGTHS]
    jp = (jax_policy("fp32") if mode == "fp32" else
          jax_policy(mode, backend="ref", gemm_mode="payload"))
    tj, sj = _jax_serve(JaxLMServer(cfg_j, jax_params, jp, slots=SLOTS,
                                    max_len=MAX_LEN), prompts)
    choices = [s.argmax(-1) for s in sj]
    tp = (make_policy("fp32") if mode == "fp32"
          else make_policy(mode, "cuda_fused", "payload"))
    tt, st = _port_serve_forced(
        LMServer(cfg, params, tp, slots=SLOTS, max_len=MAX_LEN), prompts,
        choices)
    assert tt == tj and [len(t) for t in tt] == list(NEW_TOKENS)
    assert len(st) == len(sj)
    largest, mean = SERVE_BOUNDS[mode]
    for lj, lt in zip(sj, st):
        assert lt.shape == lj.shape and np.isfinite(lt).all()
        d = np.abs(lt - lj)
        assert d.max() <= largest and d.mean() <= mean, (d.max(), d.mean())
    first = [int(np.argmax(lt[i])) for lt in st[:1] for i in range(len(lt))]
    assert first == [int(c) for c in choices[0]]


def test_paged_engine_refuses_mamba2_and_launcher_serves_dense(capsys):
    """zamba2 serves on the dense-cache engine only: the paged engine
    refuses mamba blocks, as the reference's ``PAGED_BLOCK_TYPES`` does;
    the serve launcher's dense engine serves the reduced model."""
    cfg = get_reduced_config(ARCH)
    params = tlm.init_lm(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="global-attention"):
        PayloadLMServer(cfg, params, make_policy("s2fp8"), bank={},
                        slots=2, max_len=16, block=8)
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--reduced", "--engine", "dense",
                "--device", "cpu", "--requests", "3", "--slots", "2",
                "--prompt-len", "6", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "zamba2-1.2b, engine dense" in out
    assert "[serve] 3 requests, 9 tokens" in out


def test_padding_reaches_the_mamba2_state_as_in_the_reference(jax_params):
    """The reference's fault, kept by the port (ROADMAP queue 3): LMServer
    right-pads a prompt to its bucket and ``mamba2_apply`` has no mask,
    so the scan and the conv window run on through the pads.  A 5-token
    prompt prefilled alone and padded to 8 tokens: the logits read at its
    true last index agree (fp32, f32 activations: within 1e-5), but the
    mamba2 layers' SSM states and conv windows differ, on both sides
    alike (the port's padded state within 1e-4 of the reference's)."""
    cfg_j = jax_reduced_config(ARCH).replace(activation_dtype="float32")
    cfg = get_reduced_config(ARCH).replace(activation_dtype="float32")
    params = params_from_jax(jax_params, device="cpu")
    pol = make_policy("fp32")
    prompt = np.random.default_rng(4).integers(1, cfg.vocab, 5)
    padded = np.zeros(8, np.int64)
    padded[:5] = prompt
    out = {}
    with torch.no_grad():
        for name, toks in (("alone", prompt), ("padded", padded)):
            caches = tlm.init_caches(cfg, 1, 16)
            logits, caches = tlm.prefill(
                params, torch.from_numpy(toks[None]).long(), cfg, pol, caches,
                last_index=torch.tensor([4]))
            out[name] = (logits, caches)
    cj = jax.jit(lambda p, t, c: jtlm.prefill(
        p, t, cfg_j, jax_policy("fp32"), c,
        last_index=jnp.asarray([4]))[1])(
        jax_params, jnp.asarray(padded[None]),
        jtlm.init_caches(cfg_j, 1, 16, dtype=jnp.float32))
    (la, ca), (lp, cp) = out["alone"], out["padded"]
    np.testing.assert_allclose(la.numpy(), lp.numpy(), rtol=1e-5, atol=1e-5)
    assert not torch.allclose(ca[0]["ssm"], cp[0]["ssm"])
    assert not torch.equal(ca[0]["conv"], cp[0]["conv"])
    np.testing.assert_allclose(cp[0]["ssm"].numpy(),
                               np.asarray(cj[0]["ssm"]), rtol=1e-4,
                               atol=1e-4 * float(cp[0]["ssm"].abs().max()))

