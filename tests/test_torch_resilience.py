"""The port's resilience layer against the reference's
(``tests/test_resilience.py``, ``tests/test_chaos.py`` and the TrainLoop
tests of ``tests/test_training.py`` / ``tests/test_obs.py``).

* The watchdog: bounded deque, the true even-window median, the
  ``min_history`` clamp.
* The StepGuard's verdict, held against ``repro.training.guard.evaluate``
  case by case (nonfinite, spike after warmup, saturation keeping the
  bank, forced, the carry integrating accepted steps only); the bank
  probe; ``force_refresh``; the snapshot ring (bitwise raw, lossy
  compressed, small leaves raw).
* Chaos: the spec grammar parses (and refuses) as the reference's,
  events are single-fire, the in-step channel and injectors, the host
  hooks (batch garbling, bank mutation, sleeps, the three checkpoint
  corruptions, which validation catches).
* A rejected step (``reject``, ``nan_grad``, ``inf_loss``) leaves every
  leaf of params, AdamW state (``step`` included), bank and guard carry
  bit for bit as it was, and the next step after a forced refresh, a
  chaos bank mutation, a rollback or a restore reads the new bank's cold
  sites.
* On the exact toy below (``tests/mesh_toy.py`` in torch), the port's
  TrainLoop walks the reference's ladder events under ``reject@5x3`` and
  ``saturating_bank@4``, and its ``nan_grad@5x3`` and ``reject@5x3`` runs
  end bit for bit equal.
* Telemetry and a guard without the saturation sentinel add no reduction
  to a steady step (``statsbank.count_reductions``); the telemetry drain
  sends the reference's records, reading the device only on the steps it
  forwards.
* ``--resume auto`` past a corrupt newest checkpoint, kill-and-resume bit
  for bit, watchdog trips and escalation, and the launcher end to end
  with ``--chaos``, ``--ckpt-dir`` and ``--resume auto`` on the CPU.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import mesh_toy
from repro import obs as jobs
from repro.obs import sinks as jsinks
from repro.training import chaos as jchaos
from repro.training import guard as jguard
from repro.training.trainer import TrainLoop as JaxTrainLoop
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import statsbank as tsb
from repro_torch.core.policy import make_policy
from repro_torch.obs import sinks as tsinks
from repro_torch.obs import telemetry as ttele
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.training import chaos as tchaos
from repro_torch.training import fault
from repro_torch.training import guard as tguard
from repro_torch.training.trainer import TrainLoop, make_train_step

jax.config.update("jax_platform_name", "cpu")

# ---------------------------------------------------------------------------
# the exact toy (tests/mesh_toy.py in torch): one-hot rows, constant-
# magnitude weights and cotangents, s2fp8_e4m3 payload GEMM — every sum
# exact, every site in the degenerate stats branch
# ---------------------------------------------------------------------------

B = K = 8
N_FEAT = 16
LR = 1e-3
REFRESH_EVERY = 64


def toy_params():
    w = np.zeros((K, N_FEAT), np.float32)
    rng = np.random.RandomState(0)
    for k in range(K):
        w[k, rng.randint(N_FEAT)] = rng.choice([-1.0, 1.0]) * 0.125
    return {"w": torch.from_numpy(w)}


def toy_batch(step: int):
    rng = np.random.RandomState(1000 + step)
    x = np.zeros((B, K), np.float32)
    for b in range(B):
        x[b, (b + step) % K] = rng.choice([-1.0, 1.0])
    t = rng.choice([-1.0, 1.0], size=(B, N_FEAT)).astype(np.float32)
    return {"x": torch.from_numpy(x), "t": torch.from_numpy(t)}


def toy_loss(params, batch, pol):
    y = pol.dot(batch["x"], params["w"])
    return torch.mean(torch.sum(y * batch["t"], dim=-1)), {}


def toy_setup(telemetry=False, guard=None, refresh_every=REFRESH_EVERY,
              tele=None):
    """(step_fn, params, opt_state, bank) of the toy, banked."""
    pol = make_policy("s2fp8_e4m3", gemm_mode="payload")
    params = toy_params()
    opt = topt.adamw()
    cfg = tsb.StatsConfig(refresh_every=refresh_every, telemetry=telemetry)
    bank = tsb.init_bank(toy_loss, params, toy_batch(0), pol, cfg)
    step_fn = make_train_step(toy_loss, opt, tsched.constant(LR), pol,
                              stats=cfg, guard=guard, telemetry=tele)
    return step_fn, params, opt.init(params), bank


def _chaos_batch(s, **fire):
    b = dict(toy_batch(s))
    b["_chaos"] = {n: (s if fire.get(n) else -1) for n in tchaos.IN_TRACE}
    return b


def _leaves(tree):
    return [x.detach().clone() if isinstance(x, torch.Tensor)
            else np.asarray(x).copy() for x in convert.jax_leaves(tree)]


def _assert_bitwise(a, b, msg=""):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), msg
    for i, (x, y) in enumerate(zip(la, lb)):
        x = x.numpy() if isinstance(x, torch.Tensor) else x
        y = y.numpy() if isinstance(y, torch.Tensor) else y
        assert x.dtype == y.dtype, (msg, i)
        np.testing.assert_array_equal(x, y, err_msg=f"{msg} leaf {i}")


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def test_watchdog_times_bounded_at_window():
    wd = fault.Watchdog(factor=3.0, window=8, min_history=4)
    for s in range(100):
        wd.observe(s, 0.1)
    assert len(wd.times) == 8


def test_watchdog_even_window_median_averages_middle_pair():
    wd = fault.Watchdog(factor=2.0, window=4, min_history=4)
    for s, dt in enumerate([0.1, 0.1, 0.3, 0.3]):
        assert wd.observe(s, dt) is None
    ev = wd.observe(4, 0.5)
    assert ev is not None and ev["median_s"] == pytest.approx(0.2)
    assert wd.events == [ev]


def test_watchdog_min_history_clamped_to_window():
    wd = fault.Watchdog(factor=2.0, window=4, min_history=100)
    assert wd.min_history == 4
    for s in range(4):
        wd.observe(s, 0.1)
    assert wd.observe(4, 10.0) is not None


def test_watchdog_validation():
    with pytest.raises(ValueError):
        fault.Watchdog(factor=0.0)
    with pytest.raises(ValueError):
        fault.Watchdog(window=0)


# ---------------------------------------------------------------------------
# the verdict, case by case against the reference
# ---------------------------------------------------------------------------

def test_guard_config_validation():
    with pytest.raises(ValueError, match="spike_factor"):
        tguard.GuardConfig(spike_factor=1.0)
    with pytest.raises(ValueError, match="ema_decay"):
        tguard.GuardConfig(ema_decay=1.0)


NAN, INF = float("nan"), float("inf")


@pytest.mark.parametrize("cfg,state,loss,gn,sat,forced", [
    ({}, (0.0, 0.0), 1.0, 2.0, None, None),          # first step seeds
    ({}, (3.0, 5.0), NAN, 1.0, None, None),          # nonfinite loss
    ({}, (3.0, 5.0), INF, 1.0, None, None),
    ({}, (3.0, 5.0), 1.0, NAN, None, None),          # nonfinite grads
    ({}, (3.0, 5.0), 1.0, INF, None, None),
    ({"warmup": 8}, (1.0, 3.0), 1.0, 50.0, None, None),   # disarmed
    ({"warmup": 8}, (1.0, 8.0), 1.0, 50.0, None, None),   # spike
    ({"ema_decay": 0.5}, (2.0, 1.0), 1.0, 4.0, None, None),
    ({"sat_threshold": 0.5}, (0.0, 0.0), 1.0, 1.0, -0.1, None),
    ({"sat_threshold": 0.5}, (0.0, 0.0), 1.0, 1.0, 0.2, None),
    ({}, (0.0, 0.0), 1.0, 1.0, None, True),          # forced
    ({}, (2.0, 9.0), 1.0, 1.5, None, False),
])
def test_guard_verdict_matches_jax(cfg, state, loss, gn, sat, forced):
    tc, jc = tguard.GuardConfig(**cfg), jguard.GuardConfig(**cfg)
    tst = {"gnorm_ema": torch.tensor(state[0]),
           "steps": torch.tensor(state[1])}
    jst = {"gnorm_ema": jnp.float32(state[0]), "steps": jnp.float32(state[1])}
    tflags, tnew = tguard.evaluate(
        tc, tst, torch.tensor(loss), torch.tensor(gn),
        None if sat is None else torch.tensor(sat), forced)
    jflags, jnew = jguard.evaluate(
        jc, jst, jnp.float32(loss), jnp.float32(gn),
        None if sat is None else jnp.float32(sat),
        None if forced is None else jnp.bool_(forced))
    assert set(tflags) == set(jflags)
    for k in jflags:
        assert bool(tflags[k]) == bool(jflags[k]), k
        assert tflags[k].dtype == torch.bool and tflags[k].dim() == 0
    for k in jnew:
        assert tnew[k].dtype == torch.float32 and tnew[k].dim() == 0
        assert tnew[k].item() == float(jnew[k]), k      # bit for bit
    tm, jm = tguard.flag_metrics(tflags), jguard.flag_metrics(jflags)
    assert sorted(tm) == sorted(jm) and "guard_ok_bank" not in tm
    if not bool(tflags["ok"]):        # a rejected step "didn't happen"
        assert tnew["gnorm_ema"].item() == state[0]
        assert tnew["steps"].item() == state[1]


def _probe_banks(lib):
    f = (lambda v: torch.tensor(v)) if lib == "t" else jnp.float32
    input_bank = {"a": {"fwd": {"last": f(5.0), "sat_frac": f(0.0)},
                        "bwd": {"last": f(-1.0), "sat_frac": f(0.0)}}}
    new_bank = {"a": {"fwd": {"last": f(5.0), "sat_frac": f(0.1)},
                      "bwd": {"last": f(6.0), "sat_frac": f(0.6)}}}
    ragged_in = {"a": {"fwd": {"last": f(2.0)}, "bwd": {"last": f(3.0)}}}
    ragged_new = {"a": {"fwd": {"last": f(2.0), "sat_frac": f(0.9)},
                        "bwd": {"last": f(3.0)}}}
    return [(input_bank, new_bank, 0.5), (input_bank, new_bank, 0.0),
            (ragged_in, ragged_new, 0.5)]


def test_bank_probe_matches_jax():
    for (ti, tn, th), (ji, jn, _) in zip(_probe_banks("t"),
                                         _probe_banks("j")):
        tcold, tmargin = tguard.bank_probe(ti, tn, th)
        jcold, jmargin = jguard.bank_probe(ji, jn, th)
        assert tcold.item() == float(jcold)
        assert (tmargin is None) == (jmargin is None)
        if jmargin is not None:
            assert tmargin.item() == float(jmargin)
    assert tguard.saturation_leaves(
        {"a": {"fwd": {"last": torch.tensor(1.0)}}}) is None


def test_force_refresh_only_touches_bwd_carrying_sites():
    bank = {"gemm": {"a.fwd": {"last": torch.tensor(5.0)},
                     "a.bwd": {"last": torch.tensor(5.0)}},
            "readonly": {"fwd": {"last": torch.tensor(7.0)}}}
    out = tsb.force_refresh(bank)
    assert out["gemm"]["a.fwd"]["last"].item() == -1.0
    assert out["gemm"]["a.bwd"]["last"].item() == -1.0
    assert out["readonly"]["fwd"]["last"].item() == 7.0


# ---------------------------------------------------------------------------
# snapshot ring
# ---------------------------------------------------------------------------

def _snap_tree():
    rng = np.random.RandomState(0)
    return {"w": torch.from_numpy(rng.randn(128, 64).astype(np.float32)),
            "b": torch.from_numpy(rng.randn(16).astype(np.float32)),
            "opt": topt.OptState(7, {"w": torch.ones(128, 64)}, None)}


def test_snapshot_ring_bounded_depth_and_latest():
    with pytest.raises(ValueError):
        tguard.SnapshotRing(size=0)
    ring = tguard.SnapshotRing(size=3)
    tree = _snap_tree()
    for s in range(6):
        ring.push(s, tree)
    assert len(ring) == 3 and ring.latest()[0] == 5
    assert tguard.SnapshotRing(size=2).latest() is None


def test_snapshot_ring_uncompressed_roundtrip_bitwise():
    ring = tguard.SnapshotRing(size=2)
    tree = _snap_tree()
    want = _leaves(tree)
    ring.push(4, tree)
    tree["w"].add_(1.0)                 # in place after the push
    _, back = ring.latest()
    _assert_bitwise(back, {"b": want[0], "opt": topt.OptState(
        7, {"w": want[2]}, None), "w": want[3]}, "ring")
    assert back["opt"].step == 7
    back["w"].add_(1.0)                 # a second rollback is unharmed
    _assert_bitwise(ring.latest()[1]["w"], want[3])


def test_snapshot_ring_compressed_lossy_but_close():
    ring = tguard.SnapshotRing(size=2, compress=True)
    tree = _snap_tree()
    ring.push(4, tree)
    _, back = ring.latest()
    w, bw = tree["w"].numpy(), back["w"].numpy()
    assert not np.array_equal(bw, w)
    assert np.median(np.abs(bw - w) / (np.abs(w) + 1e-6)) < 0.1
    _assert_bitwise(back["b"], tree["b"])
    assert back["opt"].step == 7
    # the big constant leaf takes the codec too: a constant is exact
    assert torch.equal(back["opt"].m["w"], tree["opt"].m["w"])


# ---------------------------------------------------------------------------
# chaos: the grammar, single-fire, the in-step channel, the host hooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "nan_grad@5x3, slow_step@12:0.5, corrupt_ckpt@10:bitflip,", "",
    "reject@0,inf_loss@2x2,saturating_bank@8,corrupt_batch@3",
    "bogus@3", "nan_grad", "nan_grad@5x0", "nan_grad@-1"])
def test_chaos_spec_parses_as_the_reference(spec):
    def parse(mod):
        try:
            return [(e.name, e.step, e.param) for e in mod.parse_spec(spec)]
        except ValueError as e:
            return str(e)
    assert parse(tchaos) == parse(jchaos)


def test_chaos_in_step_channel_is_single_fire():
    plan = tchaos.ChaosPlan.parse("nan_grad@2,inf_loss@1")
    f = plan.batch_fields(2)
    assert f == {"nan_grad": 2, "inf_loss": -1, "reject": -1}
    assert plan.batch_fields(2) == {n: -1 for n in tchaos.IN_TRACE}
    data_fn = lambda s: {"x": torch.zeros(2)}  # noqa: E731
    assert tchaos.wrap_data_fn(data_fn, None) is data_fn
    batch = tchaos.wrap_data_fn(data_fn, plan)(1)
    clean, chaos = tchaos.split_batch(batch)
    assert "_chaos" not in clean and chaos["inf_loss"] == 1
    assert "_chaos" in batch                 # the caller's batch is kept
    arr = torch.zeros(2)
    assert tchaos.split_batch(arr) == (arr, None)
    assert tchaos.split_batch({"x": arr})[1] is None
    loss, grads = torch.tensor(1.5), [torch.ones(4)]
    fire = {"nan_grad": 3, "inf_loss": 3, "reject": 3}
    assert torch.isinf(tchaos.inject_loss(fire, loss, 3))
    assert tchaos.inject_loss(fire, loss, 4) is loss
    assert torch.isnan(tchaos.inject_grads(fire, grads, 3)[0]).all()
    assert tchaos.inject_grads(fire, grads, 4) is grads
    assert tchaos.forced_reject(fire, 3) is True
    assert tchaos.forced_reject(fire, 4) is False
    assert tchaos.inject_loss(None, loss, 3) is loss
    assert tchaos.forced_reject(None, 3) is None


def test_chaos_host_hooks():
    plan = tchaos.ChaosPlan.parse(
        "corrupt_batch@1,saturating_bank@4,slow_step@3:0.25,slow_step@4")
    batch = {"x": torch.ones(3), "n": torch.ones(3, dtype=torch.int64)}
    out = plan.corrupt_batch(1, batch)
    assert torch.isnan(out["x"]).all() and (out["n"] == 0).all()
    assert plan.corrupt_batch(1, batch) is batch                # spent
    bank = {"s": {"fwd": {"last": torch.tensor(2.0),
                          "sat_frac": torch.tensor(0.1)}},
            "p": {"fwd": {"last": torch.tensor(1.0)}}}
    assert tchaos.ChaosPlan.parse("saturating_bank@4").mutate_bank(
        4, {"p": bank["p"]}) is None                            # no leaves
    assert plan.mutate_bank(4, None) is None
    out = plan.mutate_bank(4, bank)
    assert out is not bank and out["s"]["fwd"]["sat_frac"].item() == 1.0
    assert out["s"]["fwd"]["last"].item() == 2.0
    assert bank["s"]["fwd"]["sat_frac"].item() == pytest.approx(0.1)
    assert plan.mutate_bank(4, bank) is None                    # spent
    assert plan.sleep_s(3) == 0.25 and plan.sleep_s(3) == 0.0
    assert plan.sleep_s(4) == 0.75 and plan.sleep_s(5) == 0.0


@pytest.mark.parametrize("flavor,reason", [
    ("truncate", "size mismatch"), ("bitflip", "checksum mismatch"),
    ("manifest", "missing manifest")])
def test_chaos_corrupts_the_newest_checkpoint(tmp_path, flavor, reason):
    ck = CheckpointManager(str(tmp_path))
    plan = tchaos.ChaosPlan.parse(f"corrupt_ckpt@0:{flavor},corrupt_ckpt@1")
    assert plan.corrupt_checkpoint(1, ck) is None     # nothing on disk yet
    ck.save(2, {"w": torch.arange(8.0)})
    ck.save(3, {"w": torch.arange(8.0)}, blocking=False)
    out = plan.corrupt_checkpoint(0, ck)               # waits for the write
    assert out["ckpt_step"] == 3 and out["flavor"] == flavor
    ok, why = ck.validate(3)
    assert not ok and reason in why, (ok, why)
    assert ck.validate(2) == (True, "ok")
    assert plan.corrupt_checkpoint(0, ck) is None      # spent


# ---------------------------------------------------------------------------
# a rejected step is invisible, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("injector", ["reject", "nan_grad", "inf_loss"])
def test_rejected_step_is_bitwise_invisible(injector):
    step, params, opt_state, bank = toy_setup(
        telemetry=True, guard=tguard.GuardConfig())
    gs = tguard.init_state("cpu")
    for s in range(3):
        params, opt_state, bank, gs, m = step(params, opt_state, bank, gs,
                                              _chaos_batch(s), s)
        assert m["guard_ok"].item() == 1.0
    pre = _leaves((params, opt_state, bank, gs))
    p2, o2, b2, g2, m = step(params, opt_state, bank, gs,
                             _chaos_batch(3, **{injector: True}), 3)
    assert m["guard_ok"].item() == 0.0
    cause = "forced" if injector == "reject" else "nonfinite"
    assert m[f"guard_{cause}"].item() == 1.0
    assert o2.step == 3
    post = _leaves((p2, o2, b2, g2))
    assert len(pre) == len(post)
    for i, (x, y) in enumerate(zip(pre, post)):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else np.array_equal(x, y)), i


@pytest.mark.parametrize("how", ["force_refresh", "mutate_bank", "rollback",
                                 "restore"])
def test_next_step_reads_a_new_banks_cold_sites(how, tmp_path, monkeypatch):
    """The step caches the cold-site map of the bank it returned; a bank
    handed in from elsewhere is read afresh: after a forced refresh, a
    rollback or a restore to a cold bank the next (steady) step
    bootstraps every site."""
    step, params, opt_state, bank = toy_setup(telemetry=True)
    cold_bank = _leaves(bank)
    ring = tguard.SnapshotRing(2)
    ring.push(0, (params, opt_state, bank))
    ck = CheckpointManager(str(tmp_path))
    ck.save(0, (params, opt_state, bank))
    for s in range(2):
        params, opt_state, bank, m = step(params, opt_state, bank,
                                          toy_batch(s), s)
    assert m["stats_refreshed"] == 0.0
    calls = []
    real = tsb.cold_sites
    monkeypatch.setattr(tsb, "cold_sites",
                        lambda b: calls.append(1) or real(b))
    if how == "force_refresh":
        bank = tsb.force_refresh(bank)
    elif how == "mutate_bank":
        bank = tchaos.ChaosPlan.parse("saturating_bank@2").mutate_bank(
            2, bank)
    else:
        tree = (ring.latest()[1] if how == "rollback"
                else ck.restore((params, opt_state, bank))[0])
        for x, y in zip(_leaves(tree[2]), cold_bank):
            assert torch.equal(x, y)
        params, opt_state, bank = tree
    params, opt_state, bank, m = step(params, opt_state, bank, toy_batch(2),
                                      2)
    assert calls, "the new bank's cold sites were not read"
    last = torch.cat([st["last"].reshape(-1) for e in bank.values()
                      for st in e.values()])
    if how == "mutate_bank":
        assert m["stats_refreshed"] == 0.0 and bool((last == 0.0).all())
    else:
        assert m["stats_refreshed"] == 1.0 and bool((last == 2.0).all())


# ---------------------------------------------------------------------------
# the ladder on the toy, against the reference's TrainLoop
# ---------------------------------------------------------------------------

def _port_run(spec, steps=10, snapshot_every=2, telemetry=False,
              guard=None):
    plan = tchaos.ChaosPlan.parse(spec)
    step, params, opt_state, bank = toy_setup(
        telemetry=telemetry, guard=guard or tguard.GuardConfig())
    sink = tsinks.MemorySink()
    loop = TrainLoop(step, params, opt_state,
                     tchaos.wrap_data_fn(toy_batch, plan),
                     stats_bank=bank, guard_state=tguard.init_state("cpu"),
                     chaos=plan, sink=sink, log_every=0,
                     snapshot_every=snapshot_every)
    loop.run(steps)
    return loop, sink


def _jax_run(spec, steps=10, snapshot_every=2, telemetry=False,
             guard=None):
    plan = jchaos.ChaosPlan.parse(spec)
    step, params, opt_state, bank, _ = mesh_toy.setup(
        telemetry=telemetry, guard=guard or jguard.GuardConfig())
    sink = jsinks.MemorySink()
    loop = JaxTrainLoop(step, params, opt_state,
                        jchaos.wrap_data_fn(mesh_toy.make_batch, plan),
                        stats_bank=bank, guard_state=jguard.init_state(),
                        chaos=plan, sink=sink, log_every=0,
                        snapshot_every=snapshot_every)
    loop.run(steps)
    return loop, sink


def _ladder(sink):
    """The ladder's events (watchdog trips, which host timing decides, left
    out)."""
    keep = ("step", "trip", "cause", "to_step", "compressed")
    return [(r["event"],) + tuple(r.get(k) for k in keep)
            for r in sink.by_kind("event") if r["event"] in (
                "guard_tripped", "stats_refresh_forced", "rollback",
                "checkpoint_restore")]


def test_ladder_events_match_the_reference():
    loop, sink = _port_run("reject@5x3")
    _, jsink = _jax_run("reject@5x3")
    assert _ladder(sink) == _ladder(jsink)
    assert _ladder(sink) == [
        ("guard_tripped", 5, 1, "forced", None, None),
        ("guard_tripped", 6, 2, "forced", None, None),
        ("stats_refresh_forced", 6, None, None, None, None),
        ("guard_tripped", 7, 3, "forced", None, None),
        ("rollback", 7, None, None, 4, False)]
    assert all(np.isfinite(m["loss"]) for m in loop.history)
    assert len(loop.history) == 14      # 5 clean, 3 tripped, 6 replayed


def test_saturating_bank_ladder_matches_the_reference():
    """A chaos-saturated bank trips the saturation sentinel (the update is
    rejected, the bank kept) until the forced refresh re-measures it."""
    loop, sink = _port_run("saturating_bank@4", steps=8, telemetry=True,
                           guard=tguard.GuardConfig(sat_threshold=0.5))
    _, jsink = _jax_run("saturating_bank@4", steps=8, telemetry=True,
                        guard=jguard.GuardConfig(sat_threshold=0.5))
    assert _ladder(sink) == _ladder(jsink)
    assert [e[:4] for e in _ladder(sink)] == [
        ("guard_tripped", 4, 1, "sat"), ("guard_tripped", 5, 2, "sat"),
        ("stats_refresh_forced", 5, None, None)]


def test_nan_grad_and_reject_runs_end_bitwise_equal():
    loop_a, sink_a = _port_run("nan_grad@5x3")
    loop_b, sink_b = _port_run("reject@5x3")
    trips = [[(r["step"], r["trip"]) for r in s.by_kind("event")
              if r["event"] == "guard_tripped"] for s in (sink_a, sink_b)]
    assert trips[0] == trips[1] == [(5, 1), (6, 2), (7, 3)]
    assert {r["cause"] for r in sink_a.by_kind("event")
            if r["event"] == "guard_tripped"} == {"nonfinite"}
    _assert_bitwise(
        (loop_a.params, loop_a.opt_state, loop_a.stats_bank,
         loop_a.guard_state),
        (loop_b.params, loop_b.opt_state, loop_b.stats_bank,
         loop_b.guard_state), "nan-vs-reject")


def test_inf_loss_trips_nonfinite():
    loop, sink = _port_run("inf_loss@4", steps=8)
    assert [(r["step"], r["cause"]) for r in sink.by_kind("event")
            if r["event"] == "guard_tripped"] == [(4, "nonfinite")]
    assert all(np.isfinite(m["loss"]) for m in loop.history[-3:])


# ---------------------------------------------------------------------------
# reductions and the telemetry drain
# ---------------------------------------------------------------------------

def test_telemetry_and_guard_add_no_reduction_to_a_steady_step():
    def steady_count(telemetry, guard, chaos):
        tele = tobs.Telemetry(tsinks.NullSink()) if telemetry else None
        step, params, opt_state, bank = toy_setup(
            telemetry=telemetry, guard=guard, tele=tele)
        carry = [params, opt_state, bank]
        if guard is not None:
            carry.append(tguard.init_state("cpu"))
        counts = []
        for s in range(3):
            batch = _chaos_batch(s) if chaos else toy_batch(s)
            with tsb.count_reductions() as c:
                out = step(*carry, batch, s)
            carry = list(out[:-1])
            counts.append(c.n)
        return counts

    plain = steady_count(False, None, False)
    armed = steady_count(True, tguard.GuardConfig(), True)
    assert plain[1] == plain[2] and armed[1] == armed[2]
    assert armed[1] == plain[1]
    # the refresh step's health metrics are four more sums a direction
    assert armed[0] > plain[0]


def test_telemetry_drain_sends_the_references_records():
    """The port's drain and the reference's ``io_callback`` drain send the
    same site-health records for the same toy run, every metric within
    1e-5 relative or 2e-6 absolute: after the first update the moments
    are means of log2 over non-exact values, summed in another order, and
    the SNR's log10 differs in the last bits."""
    tsink, jsink = tsinks.MemorySink(), jsinks.MemorySink()
    step, params, opt_state, bank = toy_setup(
        telemetry=True, refresh_every=2, tele=tobs.Telemetry(tsink))
    for s in range(4):
        params, opt_state, bank, _ = step(params, opt_state, bank,
                                          toy_batch(s), s)
    from repro.core import statsbank as jsb
    from repro.core.policy import make_policy as jpolicy
    from repro.optim import optimizers as jopt
    from repro.optim import schedules as jsched
    from repro.training.trainer import make_train_step as jstep
    pol = jpolicy("s2fp8_e4m3", gemm_mode="payload")
    jp = mesh_toy.make_params()
    jo = jopt.adamw()
    cfg = jsb.StatsConfig(refresh_every=2, telemetry=True)
    jb = jsb.init_bank(mesh_toy.loss_fn, jp, mesh_toy.make_batch(0), pol,
                       cfg)
    js = jax.jit(jstep(mesh_toy.loss_fn, jo, jsched.constant(LR), pol,
                       stats=cfg, telemetry=jobs.Telemetry(jsink)))
    jst = jo.init(jp)
    for s in range(4):
        jp, jst, jb, m = js(jp, jst, jb, mesh_toy.make_batch(s),
                            jnp.int32(s))
    jax.block_until_ready(m)
    jax.effects_barrier()
    trecs, jrecs = (s.by_kind("site_health") for s in (tsink, jsink))
    key = lambda r: (r["step"], r["site"], r["dir"])  # noqa: E731
    assert sorted(map(key, trecs)) == sorted(map(key, jrecs))
    assert {r["dir"] for r in trecs} == set(tsb.GEMM_DIRS)
    jby = {key(r): r for r in jrecs}
    for r in trecs:
        j = jby[key(r)]
        assert set(r) == set(j)
        for f in r:
            if isinstance(r[f], float):
                assert r[f] == pytest.approx(j[f], rel=1e-5, abs=2e-6), f
    assert all(r["staleness"] == 1.0 for r in trecs if r["step"] == 3)


def test_telemetry_reads_the_device_only_on_forwarded_steps(monkeypatch):
    sink = tsinks.MemorySink()
    tele = tobs.Telemetry(sink, every=2)
    step, params, opt_state, bank = toy_setup(telemetry=True,
                                              refresh_every=2, tele=tele)
    reads = []
    real = ttele.to_host
    monkeypatch.setattr(ttele, "to_host",
                        lambda st: reads.append(1) or real(st))
    for s in range(5):
        params, opt_state, bank, _ = step(params, opt_state, bank,
                                          toy_batch(s), s)
    assert len(reads) == 3
    assert sorted({r["step"] for r in sink.by_kind("site_health")}) == \
        [0, 2, 4]
    with pytest.raises(ValueError):
        tobs.Telemetry(sink, every=0)
    with pytest.raises(ValueError, match="telemetry requires"):
        make_train_step(toy_loss, topt.adamw(), tsched.constant(LR),
                        make_policy("s2fp8"), telemetry=tele)


@pytest.mark.parametrize("compress", [False, True])
def test_telemetry_bank_checkpoint_roundtrip(tmp_path, compress):
    step, params, opt_state, bank = toy_setup(telemetry=True,
                                              refresh_every=2)
    for s in range(3):
        params, opt_state, bank, _ = step(params, opt_state, bank,
                                          toy_batch(s), s)
    ck = CheckpointManager(str(tmp_path), compress=compress)
    ck.save(3, (params, opt_state, bank))
    (rp, ro, rb), _ = ck.restore((params, opt_state, bank))
    _assert_bitwise(rb, bank, "bank")
    assert ro.step == 3
    assert tobs.has_telemetry(next(iter(rb.values()))["a.fwd"])


# ---------------------------------------------------------------------------
# TrainLoop: resume, kill-and-resume, watchdog
# ---------------------------------------------------------------------------

def _damage_first_leaf(step_dir):
    leaf = os.path.join(step_dir, sorted(
        n for n in os.listdir(step_dir) if n.endswith(".npy"))[0])
    with open(leaf, "r+b") as f:
        f.truncate(os.path.getsize(leaf) // 2)


def test_resume_auto_skips_corrupt_newest(tmp_path):
    def loop_for(sink, **kw):
        step, params, opt_state, bank = toy_setup()
        ck = CheckpointManager(str(tmp_path), event_fn=sink.emit)
        return TrainLoop(step, params, opt_state, toy_batch,
                         ckpt_manager=ck, stats_bank=bank, sink=sink,
                         log_every=0, **kw), ck

    loop, ck = loop_for(tsinks.MemorySink(), ckpt_every=2)
    loop.run(6)                              # saves at steps 2, 4, 6
    assert ck.latest_step() == 6
    _damage_first_leaf(ck._step_dir(6))
    sink2 = tsinks.MemorySink()
    loop2, _ = loop_for(sink2)
    loop2.maybe_resume()
    assert loop2.start_step == 4
    q = [r for r in sink2.by_kind("event")
         if r["event"] == "checkpoint_quarantined"]
    assert len(q) == 1 and q[0]["step"] == 6
    step, params, opt_state, bank = toy_setup()
    for s in range(4):
        params, opt_state, bank, _ = step(params, opt_state, bank,
                                          toy_batch(s), s)
    _assert_bitwise((loop2.params, loop2.opt_state, loop2.stats_bank),
                    (params, opt_state, bank), "resume-after-quarantine")


def test_kill_and_resume_is_bitwise(tmp_path):
    step, params, opt_state, bank = toy_setup(refresh_every=4)
    for s in range(10):
        params, opt_state, bank, _ = step(params, opt_state, bank,
                                          toy_batch(s), s)
    ref = (params, opt_state, bank)
    step, params, opt_state, bank = toy_setup(refresh_every=4)
    ck = CheckpointManager(str(tmp_path), keep=2)
    for s in range(6):
        params, opt_state, bank, _ = step(params, opt_state, bank,
                                          toy_batch(s), s)
    ck.save(6, (params, opt_state, bank))
    step, params, opt_state, bank = toy_setup(refresh_every=4)
    (params, opt_state, bank), start = ck.restore((params, opt_state, bank))
    assert start == 6
    for s in range(start, 10):
        params, opt_state, bank, _ = step(params, opt_state, bank,
                                          toy_batch(s), s)
    _assert_bitwise((params, opt_state, bank), ref, "kill-and-resume")


def _sleepy_step(slow, pause, base=0.02):
    """A step that takes ``base`` seconds (``pause`` on the steps in
    ``slow``): a baseline well above the host's timer noise."""
    def train_step(params, opt_state, batch, step):
        time.sleep(pause if step in slow else base)
        return params, opt_state, {"loss": torch.tensor(1.0), "lr": 1e-3}
    return train_step


def test_trainloop_watchdog_spans_and_checkpoint_events(tmp_path):
    plan = tchaos.ChaosPlan.parse("slow_step@10:0.3")
    sink = tsinks.MemorySink()
    ck = CheckpointManager(str(tmp_path))
    loop = TrainLoop(_sleepy_step((), 0.0), {"w": torch.zeros(4)},
                     {"m": torch.zeros(4)}, lambda s: {"x": torch.zeros(2)},
                     ckpt_manager=ck, ckpt_every=4, log_every=1, sink=sink,
                     chaos=plan)
    loop.run(12)
    trips = {r["step"]: r for r in sink.by_kind("event")
             if r["event"] == "watchdog"}
    assert 10 in trips, sink.records
    assert trips[10]["dt_s"] > 3.0 * trips[10]["median_s"]
    steps = sink.by_kind("train_step")
    assert [r["step"] for r in steps] == list(range(12))
    for r in steps:
        for k in ("loss", "lr", "data_ms", "step_ms", "ckpt_ms",
                  "refresh_ms"):
            assert k in r, (k, r)
    saves = [r for r in sink.by_kind("event")
             if r["event"] == "checkpoint_saved"]
    assert [r["step"] for r in saves] == [4, 8, 12]
    assert all("write_s" in r and "blocking_s" in r for r in saves)


def test_watchdog_escalation_snapshots_and_emits():
    sink = tsinks.MemorySink()
    loop = TrainLoop(_sleepy_step((10, 11), 0.25), {"w": torch.zeros(4)},
                     {"m": torch.zeros(4)}, lambda s: {"x": torch.zeros(2)},
                     log_every=0, watchdog_factor=3.0, sink=sink,
                     snapshot_every=1000, watchdog_escalate_after=2)
    loop.run(13)
    trips = [r for r in sink.by_kind("event") if r["event"] == "watchdog"]
    assert {10, 11} <= {r["step"] for r in trips}, sink.records
    esc = [r for r in sink.by_kind("event")
           if r["event"] == "watchdog_escalated"]
    assert len(esc) == 1 and esc[0]["trips"] == 2 and esc[0]["snapshot"]
    assert len(loop.ring) == 1
    assert loop.ring.latest()[0] == esc[0]["step"] + 1


# ---------------------------------------------------------------------------
# the launcher on the CPU
# ---------------------------------------------------------------------------

def test_launcher_runs_chaos_checkpoints_and_resume_on_the_cpu(tmp_path,
                                                               capsys):
    from repro_torch.launch import train
    ckdir, jsonl = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    base = ["--arch", "minicpm_2b", "--reduced", "--device", "cpu",
            "--n-layers", "2", "--batch", "2", "--seq", "16",
            "--stats-refresh-every", "4", "--telemetry", "--ckpt-dir",
            ckdir, "--ckpt-every", "4", "--snapshot-every", "2",
            "--resume", "auto"]
    loop = train.main(base + ["--steps", "10", "--chaos",
                              "nan_grad@5x3,corrupt_ckpt@8",
                              "--metrics-sink", f"jsonl:{jsonl}"])
    out = capsys.readouterr().out
    assert "step guard armed" in out and "final loss" in out
    with open(jsonl) as f:
        recs = [json.loads(line) for line in f]
    events = [(r["event"], r["step"]) for r in recs if r["kind"] == "event"]
    assert [e for e in events if e[0] in (
        "guard_tripped", "stats_refresh_forced", "rollback")] == [
        ("guard_tripped", 5), ("guard_tripped", 6),
        ("stats_refresh_forced", 6), ("guard_tripped", 7), ("rollback", 7)]
    assert ("chaos_corrupt_ckpt", 8) in events
    assert {r["kind"] for r in recs} >= {"train_step", "event",
                                         "site_health"}
    assert loop.opt_state.step == 10
    # the newest checkpoint (step 8) was damaged: the resumed run walks
    # past it to step 4's and ends at 12 steps
    # the same state tree (the guard carry included) as the first run
    loop = train.main(base + ["--steps", "12", "--guard"])
    out = capsys.readouterr().out
    assert "[trainer] resumed from step 4" in out
    assert "checkpoint_quarantined" in out
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert [r["step"] for r in lines] == list(range(4, 12))
    assert all(np.isfinite(r["loss"]) for r in lines)
    assert loop.opt_state.step == 12
    with pytest.raises(SystemExit, match="--telemetry requires"):
        train.main(["--arch", "minicpm_2b", "--reduced", "--device", "cpu",
                    "--telemetry"])
    with pytest.raises(SystemExit, match="sat_frac"):
        train.main(["--arch", "minicpm_2b", "--reduced", "--device", "cpu",
                    "--guard-sat-threshold", "0.1"])


def test_guard_state_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tguard.init_state()
    gs = tguard.init_state("cpu")
    assert gs["steps"].device.type == "cpu" and gs["steps"].dim() == 0
