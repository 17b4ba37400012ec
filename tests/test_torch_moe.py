"""The port's MoE against the JAX package's, on the CPU.

* The batched payload GEMM node (``qdot_train`` with an einsum plan),
  banked (steady and refresh steps) and exact, forward and backward, on
  the MoE expert einsums ``ecd,edf->ecf`` and the broadcast
  ``becd,edf->becf``, against the JAX node on the ``ref`` engine from one
  shared bank entry (the method of tests/test_torch_train_nodes.py, whose
  flip budgets are used here: forward 0.2% of the elements flipped and
  none further than 2% of max|value|, gradients 2% and 10%; refreshed
  stats within 1e-5, 1e-4 for the gradients' directions; ``last``
  exactly).
* Routing (``blocks.route``) gives the reference's expert choices and
  capacity picks EXACTLY — ``idx`` and ``tok_idx`` equal, the routing
  weights within 1e-6 relative — under global and grouped routing, at
  capacities that pick tied zero affinities, and with two experts built
  to tie exactly on every token.
* ``moe_fwd`` / ``_moe_fwd_grouped`` of the reduced deepseek_moe_16b on
  the same input and weights, fp32 and s2fp8 (exact stats): output, aux
  (within 1e-5 relative) and every gradient, with the bounds stated in
  the test.

The exact-stats node computes its stats on each side, and those differ in
the last bits (XLA's jitted reduction against torch's), so an operand
element at a grid boundary may take the neighbouring code on one side,
which moves a whole row (a) or column (b) of outputs — 1/96 and 1/80 of
them at these shapes.  Its budget (``EXACT``) is 5% of the elements and
10% of max|value| (measured: 1.5% and 2.5% for the forward).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.core import backend as jbackend
from repro.core import qdot as jqdot
from repro.core import statsbank as jsb
from repro.core.policy import make_policy as jax_policy
from repro.models import blocks as jblocks
from repro_torch.configs import get_reduced_config
from repro_torch.core import backend as tbackend
from repro_torch.core import qdot as tqdot
from repro_torch.core import statsbank as tsb
from repro_torch.core.policy import make_policy
from repro_torch.models import blocks as tblocks
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

K_EVERY = 16
STEADY, REFRESH = 101, 96
FWD = (2e-3, 0.02)
GRAD = (2e-2, 0.1)
EXACT = (5e-2, 0.1)
GRAD_DIRS = ("a.bwd", "b.bwd")


def _assert_close(got, want, budget, step):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got - want)
    flipped = np.mean(d > 1e-3 * np.abs(want))
    worst = d.max() / np.abs(want).max()
    assert flipped <= budget and worst <= step, (flipped, worst)


def _warm_state(x):
    return jsb.refresh_state(jnp.asarray(x), jsb.init_site_state(None),
                             jnp.float32(1.0), ema_decay=0.0,
                             target_max=15.0, backend="ref")


def _torch_entry(entry):
    return {d: {f: torch.tensor(float(v)) for f, v in st.items()}
            for d, st in entry.items()}


def _assert_states_close(tentry, jentry):
    for d, st in jentry.items():
        for f, v in st.items():
            got, want = float(tentry[d][f]), float(v)
            if f == "last":
                assert got == want, (d, f, got, want)
            else:
                np.testing.assert_allclose(
                    got, want, rtol=1e-4 if d in GRAD_DIRS else 1e-5,
                    err_msg=f"{d}.{f}")


EINSUMS = {
    "ecd,edf->ecf": ((4, 24, 32), (4, 32, 20)),
    "becd,edf->becf": ((2, 4, 24, 32), (4, 32, 20)),
}


def _einsum_inputs(spec, seed):
    ash, bsh = EINSUMS[spec]
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(ash).astype(np.float32)
    b = (rng.standard_normal(bsh) / np.sqrt(bsh[-2])).astype(np.float32)
    y = np.einsum(spec, a, b)
    g = (rng.standard_normal(y.shape) * 1e-3).astype(np.float32)
    return a, b, g


def _einsum_entry(spec, a, b, g):
    """A bank entry whose six directions were refreshed once from
    representative tensors (the out direction from the exact forward)."""
    plan = jbackend.plan_einsum(spec, a.shape, b.shape)
    y = jqdot.qdot_train(jnp.asarray(a), jnp.asarray(b), plan=plan,
                         backend="ref")
    _, vjp = jax.vjp(lambda a_, b_: jnp.einsum(spec, a_, b_),
                     jnp.asarray(a), jnp.asarray(b))
    da, db = vjp(jnp.asarray(g))
    reps = {"a.fwd": a, "a.bwd": da, "b.fwd": b, "b.bwd": db, "out.fwd": y,
            "out.bwd": g}
    return {d: _warm_state(reps[d]) for d in jsb.GEMM_DIRS}


@pytest.mark.parametrize("step", [STEADY, REFRESH])
@pytest.mark.parametrize("spec", list(EINSUMS))
def test_batched_qdot_banked_matches_jax(spec, step):
    a, b, g = _einsum_inputs(spec, 0)
    jentry = _einsum_entry(spec, a, b, g)
    plan = jbackend.plan_einsum(spec, a.shape, b.shape)
    f = jqdot._qdot_banked("ref", "e5m2",
                           jsb.StatsConfig(refresh_every=K_EVERY), plan)
    pred_f = jnp.float32(step % K_EVERY == 0)

    def jfn(a_, b_, e_):
        y2 = f(a_.reshape(plan.a2_shape), b_.reshape(plan.b2_shape), e_,
               pred_f, jnp.float32(step))
        return y2.reshape(plan.out_shape)

    y, vjp = jax.vjp(jfn, jnp.asarray(a), jnp.asarray(b), jentry)
    da, db, jcot = vjp(jnp.asarray(g))

    bank = {"qt0": _torch_entry(jentry)}
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    tplan = tbackend.plan_einsum(spec, a.shape, b.shape)
    assert tuple(tplan) == tuple(plan) and tplan.batch > 1
    with tsb.bind(bank, step, tsb.StatsConfig(refresh_every=K_EVERY)) as sess:
        ty = tqdot.qdot_train(ta, tb, plan=tplan, backend="plain")
        ty.backward(torch.from_numpy(g))
    new = tsb.merge_updates(bank, sess.updates)["qt0"]
    assert set(sess.updates.get("qt0", {})) == (
        set(jsb.GEMM_DIRS) if step == REFRESH else set())
    _assert_states_close(new, jcot)
    _assert_close(ty.detach(), y, *FWD)
    _assert_close(ta.grad, da, *GRAD)
    _assert_close(tb.grad, db, *GRAD)


@pytest.mark.parametrize("spec", list(EINSUMS))
def test_batched_qdot_exact_matches_jax(spec):
    a, b, g = _einsum_inputs(spec, 1)
    plan = jbackend.plan_einsum(spec, a.shape, b.shape)
    y, vjp = jax.vjp(lambda a_, b_: jqdot.qdot_train(a_, b_, plan=plan,
                                                     backend="ref"),
                     jnp.asarray(a), jnp.asarray(b))
    da, db = vjp(jnp.asarray(g))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    ty = tqdot.qdot_train(ta, tb, backend="plain",
                          plan=tbackend.plan_einsum(spec, a.shape, b.shape))
    ty.backward(torch.from_numpy(g))
    _assert_close(ty.detach(), y, *EXACT)
    _assert_close(ta.grad, da, *EXACT)
    _assert_close(tb.grad, db, *EXACT)


def test_batched_residuals_are_payloads_and_broadcast_b_is_stored_once():
    spec = "becd,edf->becf"
    a, b, g = _einsum_inputs(spec, 2)
    bank = {"qt0": _torch_entry(_einsum_entry(spec, a, b, g))}
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    with tsb.bind(bank, STEADY, tsb.StatsConfig(refresh_every=K_EVERY)):
        ty = tqdot.qdot_train(ta, tb, backend="plain",
                              plan=tbackend.plan_einsum(spec, a.shape,
                                                        b.shape))
    node = ty.grad_fn
    while node.name() != "_QdotBankedBackward":
        node = node.next_functions[0][0]
    saved = node.saved_tensors
    assert [t.dtype for t in saved] == [torch.float8_e5m2, torch.float32] * 2
    assert [tuple(t.shape) for t in saved] == [(8, 24, 32), (2,),
                                               (4, 32, 20), (2,)]


# ---------------------------------------------------------------------------
# routing and the MoE block
# ---------------------------------------------------------------------------

def _jax_route(router, x, m):
    """The reference's routing lines (repro/models/blocks.py:288-299 for
    x [T, d], :342-353 for x [B, S, d]), returning what ``blocks.route``
    returns."""
    grouped = x.ndim == 3
    x = jnp.asarray(x)
    logits = (jnp.einsum("bsd,de->bse", x.astype(jnp.float32), router)
              if grouped else jnp.dot(x.astype(jnp.float32), router))
    probs = jax.nn.softmax(logits, axis=-1)
    gate, idx = jax.lax.top_k(probs, m.top_k)
    aff = jnp.zeros(probs.shape, jnp.float32)
    if grouped:
        b, s = x.shape[:2]
        aff = aff.at[jnp.arange(b)[:, None, None],
                     jnp.arange(s)[None, :, None], idx].set(gate)
        mult, tokens = 16, s
    else:
        aff = aff.at[jnp.arange(x.shape[0])[:, None], idx].set(gate)
        mult, tokens = 128, x.shape[0]
    cap = int(np.ceil(tokens * m.top_k / m.n_experts * m.capacity_factor))
    cap = min(max(mult, ((cap + mult - 1) // mult) * mult), tokens)
    w_ec, tok_idx = jax.lax.top_k(jnp.swapaxes(aff, -1, -2), cap)
    return probs, idx, w_ec, tok_idx


def _router(seed, d, e, tie):
    router = (np.random.default_rng(seed).standard_normal((d, e))
              / np.sqrt(d)).astype(np.float32)
    if tie:
        router[:, 1] = router[:, 0]      # experts 0 and 1 tie on every token
    return router


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("shape", [(64, 128), (512, 128), (2, 96, 128),
                                   (4, 128, 128)])
def test_routing_indices_equal_the_reference(shape, tie):
    """(64, d): capacity 64 = every token, so most picks are tied zero
    affinities; (512, d): capacity 128 of 512; grouped rows of 96 and 128
    tokens (capacities 32 and 32 of up to ~32 routed: zeros tie again)."""
    m = get_reduced_config("deepseek_moe_16b").moe
    router = _router(0, shape[-1], m.n_experts, tie)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = _jax_route(jnp.asarray(router), x, m)
    got = tblocks.route(torch.from_numpy(router), torch.from_numpy(x), m)
    probs, idx, w_ec, tok_idx = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[1].numpy(), idx)
    np.testing.assert_array_equal(got[3].numpy(), tok_idx)
    np.testing.assert_allclose(got[0].numpy(), probs, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[2].numpy(), w_ec, rtol=1e-6, atol=1e-7)
    assert np.mean(w_ec == 0) > 0.05     # tied zeros were picked
    if tie:
        assert np.array_equal(probs[..., 0], probs[..., 1])


def _moe_inputs(routing, seed=3):
    jcfg = jax_reduced_config("deepseek_moe_16b")
    tcfg = get_reduced_config("deepseek_moe_16b")
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, routing=routing))
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, routing=routing))
    jp = jax.device_get(jblocks.init_moe(jcfg, jax.random.PRNGKey(seed)))
    tp = jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)), jp)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 64, 128)).astype(np.float32)
    cot = (rng.standard_normal(x.shape) * 1e-2).astype(np.float32)
    return jcfg, tcfg, jp, tp, x, cot


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got - want)
    return (np.linalg.norm(d) / np.linalg.norm(want),
            d.max() / np.abs(want).max())


@pytest.mark.parametrize("routing", ["global", "grouped"])
@pytest.mark.parametrize("mode", ["fp32", "s2fp8"])
def test_moe_fwd_and_gradients_match_jax(routing, mode):
    """Output, aux, and the gradients of sum(out * cot) + aux w.r.t. the
    input and every leaf.  fp32 (f32 activations: XLA's CPU dot takes no
    bf16 x bf16 -> f32 einsum of rank 4): within 1e-5 * max|JAX|, the
    GEMMs' summation order (measured at most 5.3e-7).  s2fp8 (bf16
    activations, as the model runs; exact stats): each side computes its
    own stats, which differ in the last bits, so an element at a grid
    boundary takes the neighbouring code on one side, and three payload
    GEMMs in a row spread it; elementwise flip counts mean little here, so
    the bounds are on the whole tensor, ||port - JAX|| / ||JAX||, and on
    the worst element over max|JAX|: the output <= 1e-2 and 0.05
    (measured at most 2.8e-3 and 1.4e-2), each gradient <= 5e-2 and 0.15,
    about one code step at the top of a range (measured at most 2.5e-2
    and 7.8e-2, the expert weights' dW)."""
    jcfg, tcfg, jp, tp, x, cot = _moe_inputs(routing)
    dt = jnp.float32 if mode == "fp32" else jnp.bfloat16
    jpol = jax_policy(mode, backend="ref", gemm_mode="payload")
    jx = jnp.asarray(x, dt)

    def jloss(p_, x_):
        out, aux = jblocks.moe_fwd(p_, x_, jcfg, jpol)
        return jnp.sum(out.astype(jnp.float32) * cot) + aux, (out, aux)

    (_, (jout, jaux)), (jg_p, jg_x) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jx)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        torch.float32 if mode == "fp32" else torch.bfloat16)
    tx.requires_grad_(True)
    for v in jax.tree_util.tree_leaves(tp):
        v.requires_grad_(True)
    tout, taux = tblocks.moe_fwd(tp, tx, tcfg, make_policy(mode, "plain", "payload"))
    assert tout.dtype == tx.dtype and tout.shape == tx.shape
    ((tout.float() * torch.from_numpy(cot)).sum() + taux).backward()
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    pairs = [(tout.detach(), jout), (tx.grad, jg_x),
             (tp["router"].grad, jg_p["router"])]
    pairs += [(tp[k].grad, jg_p[k]) for k in ("we_gate", "we_up", "we_down")]
    pairs += [(tp["shared"][k].grad, jg_p["shared"][k])
              for k in ("w_gate", "w_up", "w_down")]
    for i, (got, want) in enumerate(pairs):
        rel, worst = _rel(got.float(), np.asarray(jnp.asarray(
            want, jnp.float32)))
        if mode == "fp32":
            assert worst <= 1e-5, worst
        elif i == 0:
            assert rel <= 1e-2 and worst <= 0.05, (rel, worst)
        else:
            assert rel <= 5e-2 and worst <= 0.15, (i, rel, worst)
