"""The port's training nodes against the JAX package's, on the CPU.

Each autograd node of ``repro_torch.core.qdot`` — the banked and exact
payload GEMM, the banked and exact payload flash attention — is held
against its ``jax.custom_vjp`` counterpart in ``repro.core.qdot`` on the
``ref`` engine, on the same numpy inputs: the forward value, every input
gradient, and (banked) the refreshed bank entry.  Both sides read ONE
shared bank entry, warmed on the JAX side and converted (two engines that
warm their own entries quantize with other stats, and then most output
codes differ).  Steady steps (carried stats) and refresh steps
(refresh-then-use) are both covered.  Also checked: the residuals the
nodes save are 1-byte payloads plus scalars (and lse for flash), and a
bf16 operand gets a bf16 gradient.

Tolerances and their reasons.  Torch's and XLA's log2/exp2 differ in the
last ulp, so a payload code can flip at an RNE boundary, and refreshed
stats differ in the last bits, which shifts a site's whole grid by up to
~2e-4 relative.  So an element agrees when it is within 1e-3 relative of
the reference; the others are flipped codes (one code step is >= 1%),
counted against a budget and bounded in size:

  * forward values (one GEMM or attention over shared payloads): at most
    0.2% flipped, none further than 2% of max|value| (measured here:
    0.04% and 0.4%);
  * gradients, which read the quantized cotangent and multiply flipped
    codes again (a flipped code moves every score and gradient that reads
    it; small elements that cancel move most): at most 2% flipped, none
    further than 10% of max|gradient|, about one grid step at the top of
    the range (measured: 0.65% and 3.7%);
  * refreshed stats (alpha, beta and the EMA'd log2 moments) within 1e-5
    relative (f32 reductions in another order), 1e-4 for the stats of
    gradients, whose values differ where codes flipped (measured: 3e-5);
    ``last`` exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qdot as jqdot
from repro.core import statsbank as jsb
from repro_torch.core import qdot as tqdot
from repro_torch.core import statsbank as tsb
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

K_EVERY = 16
STEADY, REFRESH = 101, 96            # 101 % 16 != 0; 96 % 16 == 0
# (flipped fraction, worst deviation / max|want|), see the docstring
FWD = (2e-3, 0.02)
GRAD = (2e-2, 0.1)
GRAD_DIRS = ("a.bwd", "b.bwd", "q.bwd", "k.bwd", "v.bwd")


def _assert_close(got, want, budget, step):
    """Elements of ``got`` within 1e-3 relative of ``want``, except flipped
    codes: at most ``budget`` of the elements, none further than ``step``
    * max|want| from the reference."""
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


def _gemm_inputs(seed=0, m=48, k=96, n=40):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    g = (rng.standard_normal((m, n)) * 1e-3).astype(np.float32)
    return a, b, g


def _gemm_entry(a, b, g):
    """A GEMM node entry whose six directions were refreshed once from
    representative tensors (the out direction from the exact forward)."""
    y = jqdot._qdot_exact("ref", "e5m2")(jnp.asarray(a), jnp.asarray(b))
    da = jnp.asarray(g) @ jnp.asarray(b).T
    db = jnp.asarray(a).T @ jnp.asarray(g)
    reps = {"a.fwd": a, "a.bwd": da, "b.fwd": b, "b.bwd": db, "out.fwd": y,
            "out.bwd": g}
    return {d: _warm_state(reps[d]) for d in jsb.GEMM_DIRS}


def _find_node(out: torch.Tensor, name: str):
    todo = [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None:
            continue
        if node.name() == name:
            return node
        todo.extend(f for f, _ in node.next_functions)
    raise AssertionError(f"no {name} in the graph")


@pytest.mark.parametrize("step", [STEADY, REFRESH])
def test_qdot_banked_matches_jax(step):
    a, b, g = _gemm_inputs()
    jentry = _gemm_entry(a, b, g)
    f = jqdot._qdot_banked("ref", "e5m2",
                           jsb.StatsConfig(refresh_every=K_EVERY))
    pred_f = jnp.float32(step % K_EVERY == 0)
    y, vjp = jax.vjp(lambda a_, b_, e_: f(a_, b_, e_, pred_f,
                                          jnp.float32(step)),
                     jnp.asarray(a), jnp.asarray(b), jentry)
    da, db, jcot = vjp(jnp.asarray(g))

    bank = {"qt0": _torch_entry(jentry)}
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    with tsb.bind(bank, step, tsb.StatsConfig(refresh_every=K_EVERY)) as sess:
        ty = tqdot.qdot_train(ta, tb, backend="plain")
        ty.backward(torch.from_numpy(g))
    new = tsb.merge_updates(bank, sess.updates)["qt0"]
    # a steady step refreshes nothing; a refresh step all six directions
    assert set(sess.updates.get("qt0", {})) == (
        set(jsb.GEMM_DIRS) if step == REFRESH else set())
    _assert_states_close(new, jcot)
    _assert_close(ty.detach(), y, *FWD)
    _assert_close(ta.grad, da, *GRAD)
    _assert_close(tb.grad, db, *GRAD)


def test_qdot_exact_matches_jax():
    a, b, g = _gemm_inputs(seed=1)
    y, vjp = jax.vjp(jqdot._qdot_exact("ref", "e5m2"), jnp.asarray(a),
                     jnp.asarray(b))
    da, db = vjp(jnp.asarray(g))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    ty = tqdot.qdot_train(ta, tb, backend="plain")      # no session: exact
    ty.backward(torch.from_numpy(g))
    _assert_close(ty.detach(), y, *FWD)
    _assert_close(ta.grad, da, *GRAD)
    _assert_close(tb.grad, db, *GRAD)


def test_qdot_residuals_are_payloads():
    a, b, g = _gemm_inputs()
    bank = {"qt0": _torch_entry(_gemm_entry(a, b, g))}
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    with tsb.bind(bank, STEADY, tsb.StatsConfig(refresh_every=K_EVERY)):
        ty = tqdot.qdot_train(ta, tb, backend="plain")
    saved = _find_node(ty, "_QdotBankedBackward").saved_tensors
    assert [t.dtype for t in saved] == [torch.float8_e5m2, torch.float32] * 2
    assert [tuple(t.shape) for t in saved] == [a.shape, (2,), b.shape, (2,)]


def test_bf16_operands_get_bf16_gradients():
    a, b, g = _gemm_inputs(seed=2)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    y, vjp = jax.vjp(lambda a_, b_: jqdot.qdot_train(a_, b_, backend="ref"),
                     ja, jb)
    da, db = vjp(jnp.asarray(g))
    ta = torch.tensor(np.asarray(ja.astype(jnp.float32)),
                      dtype=torch.bfloat16, requires_grad=True)
    tb = torch.tensor(np.asarray(jb.astype(jnp.float32)),
                      dtype=torch.bfloat16, requires_grad=True)
    ty = tqdot.qdot_train(ta, tb, backend="plain")
    assert ty.dtype == torch.float32
    ty.backward(torch.from_numpy(g))
    assert ta.grad.dtype == tb.grad.dtype == torch.bfloat16
    for got, want in ((ta.grad, da), (tb.grad, db)):
        _assert_close(got.float(), want.astype(jnp.float32), *GRAD)


def _flash_inputs(seed=0, b=1, kvh=2, g=2, s=128, d=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kvh, g, s, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    cot = (rng.standard_normal((b, kvh, g, s, d)) * 1e-2).astype(np.float32)
    return q, k, v, cot


def _flash_entry(q, k, v, cot, causal, window):
    """FLASH_DIRS entry refreshed once from representative tensors (the
    reference's own warm-up in tests/test_qflash.py)."""
    out = jqdot.qflash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 window=window, backend="ref")
    reps = {"q.fwd": q, "q.bwd": cot * 0.5, "k.fwd": k, "k.bwd": cot,
            "v.fwd": v, "v.bwd": cot, "out.fwd": out, "out.bwd": cot}
    return {d: _warm_state(reps[d]) for d in jsb.FLASH_DIRS}


@pytest.mark.parametrize("step", [STEADY, REFRESH])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48)])
def test_qflash_banked_matches_jax(step, causal, window):
    q, k, v, cot = _flash_inputs()
    jentry = _flash_entry(q, k, v, cot, causal, window)
    f = jqdot._qflash_banked("ref", "e5m2",
                             jsb.StatsConfig(refresh_every=K_EVERY), causal,
                             window, 64, 64)
    pred_f = jnp.float32(step % K_EVERY == 0)
    y, vjp = jax.vjp(lambda q_, k_, v_, e_: f(q_, k_, v_, e_, pred_f,
                                              jnp.float32(step)),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jentry)
    dq, dk, dv, jcot = vjp(jnp.asarray(cot))

    bank = {"qf0": _torch_entry(jentry)}
    tq, tk, tv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    with tsb.bind(bank, step, tsb.StatsConfig(refresh_every=K_EVERY)) as sess:
        ty = tqdot.qflash_attention(tq, tk, tv, causal=causal, window=window,
                                    backend="plain", q_chunk=64, kv_chunk=64)
        ty.backward(torch.from_numpy(cot))
    new = tsb.merge_updates(bank, sess.updates)["qf0"]
    assert set(sess.updates.get("qf0", {})) == (
        set(jsb.FLASH_DIRS) if step == REFRESH else set())
    _assert_states_close(new, jcot)
    _assert_close(ty.detach(), y, *FWD)
    for t, want in ((tq, dq), (tk, dk), (tv, dv)):
        _assert_close(t.grad, want, *GRAD)


def test_qflash_exact_matches_jax():
    q, k, v, cot = _flash_inputs(seed=1)
    fn = jqdot._qflash_exact("ref", "e5m2", True, None, 64, 64)
    y, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(cot))
    tq, tk, tv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    ty = tqdot.qflash_attention(tq, tk, tv, backend="plain", q_chunk=64,
                                kv_chunk=64)
    ty.backward(torch.from_numpy(cot))
    _assert_close(ty.detach(), y, *FWD)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads):
        _assert_close(got, want, *GRAD)


def test_qflash_residuals_are_payloads():
    q, k, v, cot = _flash_inputs()
    bank = {"qf0": _torch_entry(_flash_entry(q, k, v, cot, True, None))}
    tq, tk, tv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    with tsb.bind(bank, STEADY, tsb.StatsConfig(refresh_every=K_EVERY)):
        ty = tqdot.qflash_attention(tq, tk, tv, backend="plain")
    saved = _find_node(ty, "_QflashBankedBackward").saved_tensors
    assert [t.dtype for t in saved] == [torch.float8_e5m2,
                                        torch.float32] * 4 + [torch.float32]
    assert [tuple(t.shape) for t in saved] == [
        q.shape, (2,), k.shape, (2,), v.shape, (2,), q.shape, (2,),
        q.shape[:-1] + (1,)]


def test_banked_truncation_site_matches_jax():
    """The bank-routed bidirectional truncation (site kind ``t``, the embed
    site): forward value, cotangent and refreshed entry."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((64, 32)) * 0.02).astype(np.float32)
    g = (rng.standard_normal((64, 32)) * 1e-4).astype(np.float32)
    jbank = {"embed/t0": {"fwd": _warm_state(x), "bwd": _warm_state(g)}}
    cfg = jsb.StatsConfig(refresh_every=K_EVERY)
    for step in (STEADY, REFRESH):
        def fwd(x_, bank_):
            with jsb.bind(bank_, step, cfg):
                with jsb.scope("embed"):
                    return jsb.current_session().truncate(x_)
        jy, vjp = jax.vjp(fwd, jnp.asarray(x), jbank)
        jx, jb = vjp(jnp.asarray(g))
        bank = {"embed/t0": _torch_entry(jbank["embed/t0"])}
        tx = torch.tensor(x, requires_grad=True)
        with tsb.bind(bank, step, tsb.StatsConfig(refresh_every=K_EVERY)) \
                as sess:
            with tsb.scope("embed"):
                ty = sess.truncate(tx)
            ty.backward(torch.from_numpy(g))
        new = tsb.merge_updates(bank, sess.updates)["embed/t0"]
        _assert_states_close(new, jb["embed/t0"])
        _assert_close(ty.detach(), jy, *FWD)
        _assert_close(tx.grad, jx, *GRAD)


@pytest.mark.parametrize("name", ["truncate_ste", "truncate_bidir",
                                  "fp8_truncate_bidir"])
def test_differentiable_truncations_match_jax(name):
    """The custom-gradient truncations of core/s2fp8.py: forward value and
    cotangent rule (identity / Eq. 5 with exact stats / raw e5m2)."""
    from repro.core import s2fp8 as js2
    from repro_torch.core import s2fp8 as ts2
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((40, 24)) * 0.1).astype(np.float32)
    g = (rng.standard_normal((40, 24)) * 1e-3).astype(np.float32)
    y, vjp = jax.vjp(getattr(js2, name), jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    ty = getattr(ts2, name)(tx)
    ty.backward(torch.from_numpy(g))
    _assert_close(ty.detach(), y, *FWD)
    _assert_close(tx.grad, dx, *FWD)
    st = ts2.tensor_stats(torch.from_numpy(x))
    jst = js2.tensor_stats(jnp.asarray(x))
    for k in ("mu", "m", "alpha", "beta"):
        np.testing.assert_allclose(float(st[k]), float(jst[k]), rtol=1e-5)
