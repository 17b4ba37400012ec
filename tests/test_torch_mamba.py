"""The port's Mamba-1 path against the JAX package, on the CPU.

Reduced falcon_mamba_7b (4 mamba1 layers, d 128, di 256, 8 states, dt
rank 8, vocab 512).  Params are made by ``repro.launch.api.init_params``
and carried across with ``params_from_jax``; inputs are made with numpy.
The JAX side runs jitted, as its serving engine does; its policies name
the engine and the GEMM mode (``ref``, payload), the port's the plain
engine and payload.  Tolerances are stated beside each comparison.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced_config
from repro.core.policy import make_policy as jax_policy
from repro.kernels import ref as jref
from repro.kernels.selective_scan import selective_scan_pallas
from repro.launch import api
from repro.models import blocks as jblocks
from repro_torch import kernels
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import make_policy
from repro_torch.kernels import ref as tref
from repro_torch.kernels import selective_scan as tscan
from repro_torch.models import blocks as tblocks
from repro_torch.models import transformer as tlm
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

ARCH = "falcon_mamba_7b"


def _pols(mode):
    if mode == "fp32":
        return jax_policy("fp32"), make_policy("fp32")
    return (jax_policy(mode, backend="ref", gemm_mode="payload"),
            make_policy(mode, "plain", "payload"))


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(api.init_params(jax_reduced_config(ARCH),
                                          jax.random.PRNGKey(0)))


def _scan_inputs(shape, seed=11):
    b, s, di, n = shape
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, di)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)) - 1.0)
                  ).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    a = -np.exp(rng.standard_normal((di, n)) * 0.3).astype(np.float32)
    d = rng.standard_normal(di).astype(np.float32)
    return x, dt, bm, cm, a, d


@pytest.mark.parametrize("shape", [(2, 32, 64, 8), (1, 64, 128, 16)])
def test_selective_scan_plain_vs_pallas_and_ref(shape):
    """``selective_scan_plain`` against ``selective_scan_pallas`` in
    interpret mode (block_d = 32, as tests/test_kernels.py runs it) and
    ``ref.selective_scan_ref``: y and the final h within rtol 1e-4, atol
    1e-5 (the reference's own tolerance for its kernel; here the products
    and the sum over the states round in another order)."""
    args = _scan_inputs(shape)
    yk, hk = selective_scan_pallas(*(jnp.asarray(t) for t in args),
                                   block_d=32, interpret=True)
    yr, hr = jref.selective_scan_ref(*(jnp.asarray(t) for t in args))
    kernels.reset_counts()
    yp, hp = tscan.selective_scan(*(torch.from_numpy(t) for t in args))
    assert kernels.counts()["selective_scan"] == {"launches": 0,
                                                  "plain_calls": 1}
    for want in ((yk, hk), (yr, hr)):
        np.testing.assert_allclose(yp.numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(hp.numpy(), np.asarray(want[1]),
                                   rtol=1e-4, atol=1e-5)
    yo, ho = tref.selective_scan_ref(*(torch.from_numpy(t) for t in args))
    np.testing.assert_allclose(yp.numpy(), yo.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hp.numpy(), ho.numpy(), rtol=1e-5, atol=1e-6)


def test_selective_scan_checks_shapes():
    x, dt, bm, cm, a, d = (torch.from_numpy(t) for t in
                           _scan_inputs((1, 4, 8, 2)))
    with pytest.raises(ValueError, match="A"):
        tscan.selective_scan(x, dt, bm, cm, a.T, d)
    with pytest.raises(ValueError, match="B, C"):
        tscan.selective_scan(x, dt, bm[:, :3], cm, a, d)


@pytest.mark.parametrize("mode", ["fp32", "s2fp8"])
def test_mamba1_block_prefill_and_decode_vs_reference(jax_params, mode):
    """One mamba1 block (layer 0), prefill of 8 tokens into an f32 cache
    (as LMServer's) and one decode step from it, against
    ``blocks.mamba1_apply``.  The conv windows are the same bits (copies of
    bf16 values).  fp32: the block outputs within one bf16 ulp (2^-8
    relative), the SSM state within 1e-6 of its largest entry (the scan's
    products and sum over the states round in another order).  s2fp8
    (payload GEMMs, exact stats): the outputs within 2^-7 relative, the
    state within 2e-2 of its largest entry at most and 1e-3 on average —
    the two sides' stats differ in the last bits (XLA's log2 is log *
    1/ln2; another f32 summation order), which moves dt, B and C by f32
    ulps without a bf16 rounding to absorb them."""
    cfg_j, cfg = jax_reduced_config(ARCH), get_reduced_config(ARCH)
    jp, tp = _pols(mode)
    lp = jax.tree_util.tree_map(lambda v: np.asarray(v[0]),
                                jax_params["segments"][0])
    lpt = params_from_jax(lp, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)

    step = jax.jit(lambda p, x, c, m: jblocks.mamba1_apply(
        p, x, cfg_j, jp, c, m)[:2], static_argnums=3)
    cj = jblocks.init_cache("mamba1", cfg_j, 2, 16, dtype=jnp.float32)
    yj, cj = step(lp, jnp.asarray(x, jnp.bfloat16), cj, "prefill")
    yj1, cj1 = step(lp, jnp.asarray(x1, jnp.bfloat16), cj, "decode")

    ct = tblocks.init_cache("mamba1", cfg, 2, 16)
    with torch.no_grad():
        yt, _, aux = tblocks.mamba1_apply(
            lpt, torch.from_numpy(x).bfloat16(), cfg, tp, ct, "prefill")
        ct0 = {k: v.clone() for k, v in ct.items()}
        yt1, _, _ = tblocks.mamba1_apply(
            lpt, torch.from_numpy(x1).bfloat16(), cfg, tp, ct, "decode")
    assert yt.dtype == torch.bfloat16 and float(aux) == 0.0
    assert ct["conv"].dtype == torch.float32 and ct["conv"].shape == (2, 3, 256)
    assert ct["ssm"].shape == (2, 256, 8)
    rtol = 2.0 ** -8 if mode == "fp32" else 2.0 ** -7
    for cache_j, cache_t, y_j, y_t in ((cj, ct0, yj, yt), (cj1, ct, yj1, yt1)):
        np.testing.assert_allclose(y_t.float().numpy(),
                                   np.asarray(y_j, np.float32), rtol=rtol,
                                   atol=1e-6)
        np.testing.assert_array_equal(cache_t["conv"].numpy(),
                                      np.asarray(cache_j["conv"]))
        hj, ht = np.asarray(cache_j["ssm"]), cache_t["ssm"].numpy()
        top, err = np.abs(hj).max(), np.abs(ht - hj)
        if mode == "fp32":
            assert err.max() <= 1e-6 * top
        else:
            assert err.max() <= 2e-2 * top and err.mean() <= 1e-3 * top


def test_prefill_then_decode_matches_full_forward():
    """prefill(S tokens) + decode(1) against a prefill of the S + 1 tokens
    without a cache, the counterpart of tests/test_models_smoke.py's
    ``test_prefill_decode_consistency`` (f32 activations, fp32 policy,
    its tolerances: 1e-4 at prefill, 1e-3 after the decode step)."""
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


def test_training_a_mamba1_block_matches_jax_grad(jax_params):
    """One mamba1 block (layer 0) in ``mode="train"``, fp32 on an f32 input
    of 2 x 40 tokens: the output within rtol 1e-4, and the gradients of a
    fixed projection of it with respect to the input and every leaf
    against ``jax.grad`` of ``blocks.mamba1_apply`` within rtol 2e-3, atol
    2e-4 of each leaf's largest entry (tests/test_hillclimb_equivalence.py's
    tolerance).  The scan's gradient is ``SelectiveScanFn``'s (the plain
    backward on the CPU: one plain forward and one plain backward call)."""
    cfg_j, cfg = jax_reduced_config(ARCH), get_reduced_config(ARCH)
    pol_j, pol_t = _pols("fp32")
    lp = jax.tree_util.tree_map(lambda v: np.asarray(v[0]),
                                jax_params["segments"][0])
    lpt = params_from_jax(lp, device="cpu")
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y = jblocks.mamba1_apply(p, x, cfg_j, pol_j, None, "train")[0]
        return jnp.sum(y * w), y

    (_, yj), (gpj, gxj) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(lp, jnp.asarray(x))
    leaves = {k: v for k, v in lpt.items() if k != "ln"}
    leaves["ln/scale"] = lpt["ln"]["scale"]
    for v in leaves.values():
        v.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    kernels.reset_counts()
    yt = tblocks.mamba1_apply(lpt, xt, cfg, pol_t, None, "train")[0]
    grads = torch.autograd.grad((yt * torch.from_numpy(w)).sum(),
                                [xt] + list(leaves.values()))
    counts = kernels.counts()
    assert counts["selective_scan"]["plain_calls"] == 1
    assert counts["selective_scan_bwd"]["plain_calls"] == 1
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=1e-4, atol=1e-5)
    want = [np.asarray(gxj)] + [
        np.asarray(gpj["ln"]["scale"] if k == "ln/scale" else gpj[k])
        for k in leaves]
    for name, g, wj in zip(["x"] + list(leaves), grads, want):
        np.testing.assert_allclose(g.numpy(), wj, rtol=2e-3,
                                   atol=2e-4 * np.abs(wj).max(),
                                   err_msg=name)


@pytest.mark.parametrize("get_jax,get_port", [
    (jax_config, get_config), (jax_reduced_config, get_reduced_config)])
def test_n_params_matches_reference(get_jax, get_port):
    cfg_j, cfg = get_jax(ARCH), get_port(ARCH)
    assert cfg.n_params() == cfg_j.n_params()
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.pattern) == (
        cfg_j.n_layers, cfg_j.d_model, cfg_j.vocab, cfg_j.pattern)
    assert dict(vars(cfg.ssm)) == dict(vars(cfg_j.ssm))
    if get_port is get_config:
        assert cfg.n_params() == 7_270_825_984
        assert cfg.ssm.expand * cfg.d_model == 8192 and not cfg.tie_embeddings


def test_convert_carries_the_mamba_leaves(jax_params):
    """Every leaf of the JAX tree arrives under its name, in its layout,
    with its values; the port's own ``init_lm`` makes the same tree."""
    tree = params_from_jax(jax_params, device="cpu")
    seg_j, seg_t = jax_params["segments"][0], tree["segments"][0]
    mamba_leaves = {"ln", "w_in", "conv_w", "conv_b", "w_x", "w_dt", "b_dt",
                    "a_log", "d_skip", "w_out"}
    assert set(seg_t) == set(seg_j) == mamba_leaves
    for name in mamba_leaves - {"ln"}:
        np.testing.assert_array_equal(seg_t[name].numpy(),
                                      np.asarray(seg_j[name]))
    np.testing.assert_array_equal(seg_t["ln"]["scale"].numpy(),
                                  np.asarray(seg_j["ln"]["scale"]))
    assert set(tree) == {"embed", "final_norm", "segments", "head"}
    own = tlm.init_lm(get_reduced_config(ARCH), seed=0, device="cpu")
    flat_own = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: tuple(t.shape), own,
                               is_leaf=torch.is_tensor))
    flat_jax = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda a: tuple(a.shape), jax_params))
    assert [(str(p), s) for p, s in flat_own] == \
        [(str(p), s) for p, s in flat_jax]
    # the deterministic leaves: A = -(1..n) per channel (log within an
    # ulp), dt's bias, D, the conv bias and the norm scale
    for name in ("a_log", "b_dt", "d_skip", "conv_b"):
        np.testing.assert_allclose(own["segments"][0][name].numpy(),
                                   np.asarray(seg_j[name]), rtol=1e-6)
