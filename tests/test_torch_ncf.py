"""The port's NCF (``repro_torch.models.ncf``) against the JAX package's,
on the CPU: ``ncf_logits``, ``loss_fn`` (and its gradients), ``hit_ratio``
and 10 steps of ``make_train_step`` (AdamW at the example's 2e-3) in
fp32, s2fp8 (payload and fig4) and fp8; the NCF batch generator.

Both sides start from JAX ``init_ncf`` params (64 users, 48 items, 8
factors, the paper's MLP tower 64-32-16-8) carried over by
``convert.params_from_jax`` and from JAX ``ncf_batch`` batches as numpy
arrays; the JAX side is the ``ref`` engine, the port the ``plain`` engine
with the same ``gemm_mode``.  NCF's activations are f32.  Tolerances are
stated beside each assert.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.core.policy import make_policy as jax_policy
from repro.data import synthetic as jsyn
from repro.models import ncf as jncf
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.training.trainer import make_train_step as jax_train_step
from repro_torch.configs import get_config
from repro_torch.configs import ncf_ml1m
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import make_policy
from repro_torch.data import synthetic
from repro_torch.models import ncf
from repro_torch.optim import optimizers, schedules
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.training.trainer import make_train_step

jax.config.update("jax_platform_name", "cpu")

N_USERS, N_ITEMS, BATCH = 64, 48, 32
MODES = [("fp32", None), ("s2fp8", "payload"), ("s2fp8", "fig4"),
         ("fp8", None)]


def _pols(mode, gemm_mode):
    kw = {} if gemm_mode is None else {"gemm_mode": gemm_mode}
    return (jax_policy(mode, backend="ref", **kw),
            make_policy(mode, "plain", **kw))


@pytest.fixture(scope="module")
def side():
    # jitted: eager JAX compiles each random op on its own
    params = jax.jit(lambda key: jncf.init_ncf(key, N_USERS, N_ITEMS))(
        jax.random.PRNGKey(0))
    draw = jax.jit(lambda s: jsyn.ncf_batch(0, s, BATCH, N_USERS, N_ITEMS))
    batches = [{k: np.asarray(v) for k, v in draw(s).items()}
               for s in range(10)]
    neg = np.random.default_rng(1).integers(0, N_ITEMS, (BATCH, 99))
    return {"jp": params, "np_p": jax.device_get(params), "batches": batches,
            "neg": neg}


def _tb(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


@pytest.mark.parametrize("mode,gemm_mode", MODES)
def test_logits_loss_and_hit_ratio_match_jax(side, mode, gemm_mode):
    """``ncf_logits``, ``loss_fn`` and HR@10 on the same params and batch.
    fp32: logits within 1e-4 * max|JAX| and the loss within 1e-4 relative
    (f32 sums in another order).  The truncating modes truncate both
    tables whole before the lookup and every GEMM's operands and output:
    raw fp8 has no stats and matches JAX exactly here, while in s2fp8 the
    last GEMM's 32 outputs are truncated with stats of their own, and the
    two sides' stats differ in the last bits (XLA's log2, ROADMAP queue
    3), which moves the whole grid: every logit within 25% of its JAX
    value, one e5m2 grid step (measured at most 12%, on 31 of 32 logits).
    The loss within 1e-3 (logits of order 1e-3 keep it near log 2).
    HR@10 over 99 negatives: at most one user of 32 apart."""
    jpol, tpol = _pols(mode, gemm_mode)
    b = side["batches"][0]
    params = params_from_jax(side["np_p"], device="cpu")
    jl, jloss, jhr = jax.jit(lambda p: (
        jncf.ncf_logits(p, b["users"], b["items"], jpol),
        jncf.loss_fn(p, b, jpol)[0],
        jncf.hit_ratio(p, b["users"], b["items"], jnp.asarray(side["neg"]),
                       jpol)))(side["jp"])
    jl, jhr = np.asarray(jl), float(jhr)
    tb = _tb(b)
    with torch.no_grad():
        tl = ncf.ncf_logits(params, tb["users"], tb["items"], tpol).numpy()
        tloss, metrics = ncf.loss_fn(params, tb, tpol)
        thr = float(ncf.hit_ratio(params, tb["users"], tb["items"],
                                  torch.from_numpy(side["neg"]), tpol))
    assert tl.shape == (BATCH,)
    if mode == "fp32":
        assert np.abs(tl - jl).max() <= 1e-4 * np.abs(jl).max()
    else:
        assert (np.abs(tl - jl) <= 0.25 * np.abs(jl)).all()
    lim = 1e-4 * abs(float(jloss)) if mode == "fp32" else 1e-3
    assert abs(float(tloss) - float(jloss)) <= lim
    assert float(metrics["nll"]) == float(tloss)
    assert abs(thr - jhr) <= 1.0 / BATCH + 1e-9, (thr, jhr)


@pytest.mark.parametrize("mode,gemm_mode", MODES)
def test_gradients_match_jax(side, mode, gemm_mode):
    """Every leaf's gradient.  fp32: within 1e-4 relative (L2; measured
    2e-7).  The truncating modes truncate the whole table's cotangent with
    stats of its own (mostly zeros: only the batch's rows are touched),
    and every GEMM's cotangents on the e5m2 grid, and NCF's small values
    (tables of sd 0.01) keep many of them near the flush threshold, so
    leaves differ by independent rounding noise (measured 14-56% a leaf):
    each leaf's L2 norm within [0.6, 1.5] of JAX's (measured 0.72-1.12)
    and the concatenated gradients' cosine at least 0.85 (measured 0.92 in
    s2fp8, 0.96 in fp8)."""
    jpol, tpol = _pols(mode, gemm_mode)
    b = side["batches"][0]
    jg = jax.jit(jax.grad(lambda p: jncf.loss_fn(p, b, jpol)[0]))(side["jp"])
    jg = [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)]
    params = params_from_jax(side["np_p"], device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = ncf.loss_fn(params, _tb(b), tpol)
    tg = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
    assert [g.shape for g in tg] == [g.shape for g in jg]
    if mode == "fp32":
        for got, want in zip(tg, jg):
            assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
        return
    for got, want in zip(tg, jg):
        ratio = np.linalg.norm(got) / np.linalg.norm(want)
        assert 0.6 <= ratio <= 1.5, ratio
    cat_t = np.concatenate([g.ravel() for g in tg])
    cat_j = np.concatenate([g.ravel() for g in jg])
    cos = cat_t @ cat_j / (np.linalg.norm(cat_t) * np.linalg.norm(cat_j))
    assert cos >= 0.85, cos


@pytest.mark.parametrize("mode,gemm_mode", [("fp32", None),
                                            ("s2fp8", "payload"),
                                            ("fp8", None)])
def test_train_steps_match_jax(side, mode, gemm_mode):
    """10 steps of ``make_train_step`` with AdamW at a constant 2e-3 (the
    example's recipe: lr 5e-4 x 4), from the same params and batches, on
    both sides: per-step |port - JAX| loss at most 1e-5 in fp32 (measured
    6e-8) and 1e-3 in s2fp8 and fp8 (measured at most 2.5e-4: flipped
    codes move the updates), every loss finite."""
    jpol, tpol = _pols(mode, gemm_mode)
    jo = jopt.adamw()
    jstep = jax.jit(jax_train_step(jncf.loss_fn, jo, jsched.constant(2e-3),
                                   jpol))
    jp, js = side["jp"], jo.init(side["jp"])
    params = params_from_jax(side["np_p"], device="cpu")
    opt = optimizers.adamw()
    step = make_train_step(ncf.loss_fn, opt, schedules.constant(2e-3), tpol)
    state = opt.init(params)
    lim = 1e-5 if mode == "fp32" else 1e-3
    for s, b in enumerate(side["batches"]):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()},
                           jnp.int32(s))
        params, state, m = step(params, state, _tb(b), s)
        assert np.isfinite(float(m["loss"]))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= lim, (
            s, float(m["loss"]), float(jm["loss"]))


def test_ncf_batch_shapes_and_ranges():
    """Implicit feedback at ML-1M's sizes: users in [0, 6040), items in [0,
    3706), labels in {0, 1} with a positive share near the preference
    model's mean of 1/2; the same seed gives the same factors."""
    cfg = get_config("ncf_ml1m")
    assert cfg.family == "mlp"
    prefs = synthetic.ncf_preferences(0, ncf_ml1m.N_USERS, ncf_ml1m.N_ITEMS)
    assert tuple(prefs.users.shape) == (6040, 8)
    assert tuple(prefs.items.shape) == (3706, 8)
    assert torch.equal(prefs.users, synthetic.ncf_preferences(
        0, 6040, 3706).users)
    b = synthetic.ncf_batch(prefs, torch.Generator().manual_seed(0), 4096,
                            device="cpu")
    assert {k: tuple(v.shape) for k, v in b.items()} == {
        "users": (4096,), "items": (4096,), "labels": (4096,)}
    assert all(v.dtype == torch.int64 for v in b.values())
    assert int(b["users"].max()) < 6040 and int(b["items"].max()) < 3706
    assert set(b["labels"].unique().tolist()) <= {0, 1}
    assert 0.4 < float(b["labels"].float().mean()) < 0.6


def test_params_from_jax_carries_the_ncf_tree(side):
    """The converted tree holds JAX's leaves and values (``mlp`` a list of
    {w, b}); the port's ``init_ncf`` makes the same tree, with the final
    GEMM's N = 1."""
    params = params_from_jax(side["np_p"], device="cpu")
    jl = jax.tree_util.tree_leaves(side["np_p"])
    assert all(np.array_equal(g.numpy(), np.asarray(w))
               for g, w in zip(tree_leaves(params), jl))
    own = ncf.init_ncf(N_USERS, N_ITEMS, device="cpu")
    assert tuple(own["out"].shape) == (16, 1)
    assert [tuple(x["w"].shape) for x in own["mlp"]] == [
        tuple(x["w"].shape) for x in params["mlp"]]
    assert {k: tuple(v.shape) for k, v in own.items() if k != "mlp"} == {
        k: tuple(v.shape) for k, v in params.items() if k != "mlp"}
