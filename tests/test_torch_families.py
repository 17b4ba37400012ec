"""The attention-family configs of the port against the JAX package, on
the CPU: gemma3_1b (``local`` blocks, ``gelu_glu``), stablelm_12b,
nemotron_4_340b (``sq_relu``, layer norm), chameleon_34b (the ``vq_stub``
frontend: token ids) and kimi_k2_1t_a32b (384 experts top-8; reduced 8
top-2).

Tolerances, and why:

  * configs: every field equal, full and reduced; ``n_params`` equal,
    except that the port counts a ``dense_first`` block, which the
    reference's formula skips (kimi: the difference is that block's
    weights, exactly);
  * activations: ``gelu_glu`` and ``sq_relu`` per op against the jitted
    JAX ``activate`` on the same inputs: bit for bit in bf16 and for
    ``sq_relu``, except that XLA flushes subnormal results to zero (counted:
    only the planted near-zero gates give them); ``gelu_glu`` in f32
    within 1e-6 relative + 4e-6 (torch's and XLA's tanh differ by a few
    ulps, measured 1.7e-6; XLA's reaches -1 below a gate of ~ -4.8, giving 0);
  * forward: fp32 with f32 activations within 1e-4 of the largest logit
    (the same function; f32 sums in another order), on every family;
    reduced gemma3's s2fp8 payload forward and prefill logits at 2 x 96
    tokens (past its window of 64) within max 0.1 / mean 0.02, the
    prefill budget of ROADMAP queue 3;
  * long attention: the chunked flash route above 2,048 tokens at head dim
    256 with a window, fp32 loss within 1e-5 relative and gradients within
    1e-4 of each leaf's largest;
  * training: tests/test_torch_families_train.py;
  * params_from_jax and checkpoints: bit for bit, both ways.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.configs import base as jax_configs
from repro.core.policy import make_policy as jax_policy
from repro.launch import api as japi
from repro.models import blocks as jblocks
from repro.models import transformer as jtlm
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import base as port_configs
from repro_torch.core.policy import make_policy
from repro_torch.launch import api
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import blocks
from repro_torch.models import transformer as tlm
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

NEW_ARCHS = ("gemma3_1b", "stablelm_12b", "nemotron_4_340b",
             "chameleon_34b", "kimi_k2_1t_a32b")


def _dense_first_params(cfg):
    return sum(cfg._block_params(b, 0) for b in cfg.resolved_pattern
               if b == "dense_first")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_matches_reference(arch, reduced):
    get = "get_reduced_config" if reduced else "get_config"
    ref = getattr(jax_configs, get)(arch)
    port = getattr(port_configs, get)(arch)
    names = {f.name for f in dataclasses.fields(port)}
    # the reference's engine field (the port's engine is the policy's)
    assert {f.name for f in dataclasses.fields(ref)} - names == {
        "numerics_backend"}
    for name in names:
        p, r = getattr(port, name), getattr(ref, name)
        if dataclasses.is_dataclass(p):
            p, r = dataclasses.asdict(p), dataclasses.asdict(r)
        assert p == r, (arch, name, p, r)
    assert port.n_params() == ref.n_params() + _dense_first_params(port)
    assert port.n_active_params() <= port.n_params()


def test_arch_ids_are_the_reference_minus_zamba2():
    """Since zamba2_1p2b was ported, none is missing: the port's tuple is
    the reference's, in its order."""
    assert port_configs.ARCH_IDS == jax_configs.ARCH_IDS


def test_published_sizes():
    """The params the published widths give (the chip run's memory is
    reckoned from these): gemma3_1b ~1.00 B, stablelm_12b ~12.1 B,
    nemotron_4_340b ~341 B (9.44 B of it embedding and head, 3.45 B a
    layer), kimi ~1.03 T."""
    get = port_configs.get_config
    assert round(get("gemma3_1b").n_params() / 1e9, 2) == 1.00
    assert round(get("stablelm_12b").n_params() / 1e9, 1) == 12.1
    nem = get("nemotron_4_340b")
    head = 2 * nem.vocab * nem.d_model
    assert round(head / 1e9, 2) == 9.44
    assert round(nem._block_params("dense", 0) / 1e9, 2) == 3.45
    assert round(nem.n_params() / 1e9) == 341
    assert round(get("kimi_k2_1t_a32b").n_params() / 1e12, 2) == 1.03


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu_glu", "sq_relu"])
def test_activation_matches_jax(act, dtype):
    rng = np.random.default_rng(1)
    gate = (rng.standard_normal((64, 512)) * 3.0).astype(np.float32)
    lin = rng.standard_normal((64, 512)).astype(np.float32)
    gate[0, :64] = np.logspace(-45, -36, 64, dtype=np.float64).astype(
        np.float32) * np.where(np.arange(64) % 2, 1, -1)   # subnormal region
    gate[1, :8] = [0.0, -0.0, 1e-30, -1e-30, 20.0, -20.0, 1e-20, -1e-20]
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    want = jax.jit(lambda g, h: jblocks.activate(g, h, act))(
        jnp.asarray(gate, jd), jnp.asarray(lin, jd))
    got = blocks.activate(torch.from_numpy(gate).to(td),
                          torch.from_numpy(lin).to(td), act)
    assert got.dtype == td
    w = np.asarray(want.astype(jnp.float32))
    g = got.float().numpy()
    tiny = np.finfo(np.float32).tiny
    # XLA flushes subnormal results to zero: counted, and the only
    # elements allowed to differ in bf16 and in sq_relu
    flushed = (w == 0) & (g != 0) & (np.abs(g) < tiny)
    if act == "sq_relu" or dtype == "bfloat16":
        np.testing.assert_array_equal(np.where(flushed, 0.0, g), w)
        assert not flushed[2:].any()         # only the planted tiny gates
        return
    # f32 gelu_glu: the two tanh implementations differ by a few ulps, and
    # XLA's reaches -1 (a 0 result) below a gate of about -4.8 (an argument
    # of -8), where torch's is still 2e-7 above it
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=4e-6)
    assert not flushed[2:].any()
    saturated = (w == 0) & (g != 0) & ~flushed
    assert np.all(gate[saturated] < -4.5), gate[saturated].max()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _pair(arch, **kw):
    cfg_j = jax_configs.get_reduced_config(arch).replace(remat=False, **kw)
    cfg = port_configs.get_reduced_config(arch).replace(**kw)
    params_j = japi.init_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg, params_j, convert.params_from_jax(
        jax.device_get(params_j), device="cpu")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_fp32_matches_jax(arch):
    """fp32 with f32 activations, batch 2 x 96 (past gemma3's window of
    64): the same function."""
    cfg_j, cfg, pj, pt = _pair(arch, activation_dtype="float32")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 96))
    x, _, _ = jtlm.forward(pj, jnp.asarray(toks, jnp.int32), cfg_j,
                           jax_policy("fp32"), mode="train")
    want = np.asarray(jtlm.lm_head(pj, x, cfg_j, jax_policy("fp32")))
    with torch.no_grad():
        y, _, _ = tlm.forward(pt, torch.from_numpy(toks), cfg,
                              make_policy("fp32"), mode="train")
        got = tlm.lm_head(pt, y, cfg, make_policy("fp32")).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_gemma3_s2fp8_forward_and_prefill_match_jax():
    """Reduced gemma3 (local, local, dense, local; window 64) in s2fp8
    payload, 2 x 96 tokens: training forward logits and prefill logits
    (caches: rings of 64 for the local layers) against the JAX ref
    engine."""
    cfg_j, cfg, pj, pt = _pair("gemma3_1b")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 96))
    jpol = jax_policy("s2fp8", backend="ref", gemm_mode="payload")
    tpol = make_policy("s2fp8", "plain", "payload")
    x, _, _ = jtlm.forward(pj, jnp.asarray(toks, jnp.int32), cfg_j, jpol,
                           mode="train")
    want = np.asarray(jtlm.lm_head(pj, x, cfg_j, jpol).astype(jnp.float32))
    jl, jc = jtlm.prefill(pj, jnp.asarray(toks, jnp.int32), cfg_j, jpol,
                          jtlm.init_caches(cfg_j, 2, 128, dtype=jnp.float32))
    with torch.no_grad():
        y, _, _ = tlm.forward(pt, torch.from_numpy(toks), cfg, tpol,
                              mode="train")
        got = tlm.lm_head(pt, y, cfg, tpol).float().numpy()
        tl, tc = tlm.prefill(pt, torch.from_numpy(toks), cfg, tpol,
                             tlm.init_caches(cfg, 2, 128, device="cpu"))
    for a, b in ((got, want), (tl.float().numpy(),
                               np.asarray(jl.astype(jnp.float32)))):
        d = np.abs(a - b)
        assert d.max() <= 0.1 and d.mean() <= 0.02, (d.max(), d.mean())
    assert [tuple(c["k"].shape) for c in tc] == [
        tuple(c["k"].shape) for c in jc] == [
        (2, 2, 1, 64, 32), (1, 2, 1, 128, 32), (1, 2, 1, 64, 32)]


def test_long_windowed_attention_at_head_dim_256():
    """Reduced gemma3 at head dim 256 (one head, one K/V head), 2 layers
    (local with window 512, dense), batch 1 x 3072 with ``attn_impl``
    flash: above 2,048 tokens both packages take the chunked flash route
    with the recompute backward (the local layer masked to 512 keys).
    fp32 with f32 activations: loss and gradients."""
    kw = dict(n_layers=2, n_heads=1, kv_heads=1, head_dim=256, window=512,
              pattern=("local", "dense"), attn_impl="flash",
              activation_dtype="float32")
    cfg_j, cfg, pj, pt = _pair("gemma3_1b", **kw)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, 3073))
    inp, lab = toks[:, :-1], toks[:, 1:]
    jloss = lambda p: jtlm.loss_fn(p, jnp.asarray(inp, jnp.int32),  # noqa
                                   jnp.asarray(lab, jnp.int32), cfg_j,
                                   jax_policy("fp32"))[0]
    jv, jg = jax.value_and_grad(jloss)(pj)
    for t in jax.tree_util.tree_leaves(pt):
        t.requires_grad_(True)
    tv, _ = tlm.loss_fn(pt, torch.from_numpy(inp), torch.from_numpy(lab),
                        cfg, make_policy("fp32"))
    tv.backward()
    assert abs(float(tv.detach()) - float(jv)) <= 1e-5 * abs(float(jv))
    tg = convert.jax_leaves(jax.tree_util.tree_map(
        lambda t: t.grad, pt, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    jgl = jax.tree_util.tree_leaves(jg)
    assert len(tg) == len(jgl)
    for a, b in zip(tg, jgl):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max() + 1e-12


# ---------------------------------------------------------------------------
# params and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_and_checkpoints_cross_bitwise(arch, tmp_path):
    """``params_from_jax`` keeps every leaf (nemotron's MLP has no
    ``w_up``; kimi's experts are stacked [L, E, d, f]) and ``jax_leaves``
    gives them back in JAX's order, bit for bit; a checkpoint written by
    either package restores in the other bit for bit; the port's
    ``init_lm`` makes the same tree."""
    cfg_j, cfg, pj, pt = _pair(arch)
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.device_get(pj))]
    tleaves = [x.numpy() for x in convert.jax_leaves(pt)]
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_array_equal(a, b)
    own = tlm.init_lm(cfg, seed=1, device="cpu")
    assert [tuple(x.shape) for x in convert.jax_leaves(own)] == [
        x.shape for x in jleaves]
    mlp = pt["segments"][0].get("mlp", {})
    assert ("w_up" in mlp) == cfg.activation.endswith("_glu")

    JaxManager(str(tmp_path / "jax")).save(2, jax.device_get(pj))
    restored, step = CheckpointManager(str(tmp_path / "jax")).restore(own)
    assert step == 2
    for a, b in zip(convert.jax_leaves(restored), jleaves):
        np.testing.assert_array_equal(a.numpy(), b)
    CheckpointManager(str(tmp_path / "port")).save(3, own)
    back, step = JaxManager(str(tmp_path / "port")).restore(pj)
    assert step == 3
    for a, b in zip(jax.tree_util.tree_leaves(back), convert.jax_leaves(own)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_launcher_trains_reduced(arch, capsys):
    train_launcher.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--steps", "2", "--batch", "2", "--seq", "24"])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    losses = [json.loads(l)["loss"] for l in lines]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_launcher_serves_reduced(arch, capsys):
    engine = "dense" if arch == "gemma3_1b" else "payload"
    serve_launcher.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--engine", engine, "--requests", "3",
                         "--new-tokens", "4", "--prompt-len", "12",
                         "--max-len", "32"])
    out = capsys.readouterr().out
    assert f"engine {engine}" in out and "3 requests, 12 tokens" in out


def test_serve_launcher_refuses_payload_engine_on_gemma3():
    with pytest.raises(ValueError, match="window rings / ssm states need "
                                         "the dense engine"):
        serve_launcher.main(["--arch", "gemma3_1b", "--reduced", "--device",
                             "cpu", "--engine", "payload", "--requests", "1",
                             "--calib-passes", "1"])


def test_api_step_functions_run_gemma3_local_rings():
    """``launch/api.py``'s prefill and decode steps on reduced gemma3: the
    local layers' caches are rings of the window, and decoding past it
    wraps them."""
    cfg = port_configs.get_reduced_config("gemma3_1b")
    pol = make_policy("fp32")
    params = api.init_params(cfg, seed=0, device="cpu")
    caches = tlm.init_caches(cfg, 1, 128, device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 60), generator=torch.Generator(
        ).manual_seed(0))
    with torch.no_grad():
        logits, caches = api.make_prefill_step(cfg, pol)(
            params, {"tokens": toks}, caches)
        decode = api.make_decode_step(cfg, pol)
        for pos in range(60, 72):
            tok = logits[:, -1].argmax(-1)[:, None]
            logits, caches = decode(params, {"token": tok}, caches,
                                    torch.tensor([pos], dtype=torch.int32))
            assert torch.isfinite(logits).all()
    assert caches[0]["k"].shape[3] == cfg.window
    assert caches[1]["k"].shape[3] == 128
