"""The port's observability layer (``repro_torch.obs``) against the
reference's (``tests/test_obs.py``).

* Health metrics: ``statsbank.refresh_state`` on a telemetry state, three
  refreshes in a row (the bootstrap, a 2^12x hotter tensor measured with
  the carried stats, a 2^-9x colder one), in e5m2 and e4m3, on each of
  the port's engines (``plain``; ``cuda`` and ``cuda_fused`` take their
  kernels' plain versions on the CPU) against the JAX ``ref`` engine.
  Tolerances: ``sat_frac`` / ``uflow_frac`` within 2 elements of the
  count (a code flip at an RNE boundary moves one element; none were
  seen), (alpha, beta) and the moments 2e-6 relative (the mean of log2
  summed in another order), ``qmse`` 1e-5 relative, ``qsnr_db`` 1e-4 dB,
  drifts 1e-5 absolute.
* ``ensure_telemetry`` / ``strip_telemetry``, ``resolve_fmt``.
* ``telemetry_state`` / ``state_records`` of the same bank give the
  reference's records.
* The sinks: jsonl, csv (header union), console (the reference's lines,
  character for character), ``make_sink``, tee.
* The doctor: a saturating site is flagged (e4m3 -> e5m2), a healthy and
  a cold probe report clean; ``site_report`` / ``format_report`` of one
  bank give the reference's rows and text.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.core import s2fp8 as js2
from repro.core import statsbank as jsb
from repro.obs import doctor as jdoctor
from repro.obs import metrics as jmetrics
from repro.obs import sinks as jsinks
from repro.obs import telemetry as jtele
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch.core import statsbank as tsb
from repro_torch.core.policy import make_policy
from repro_torch.obs import doctor as tdoctor
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import sinks as tsinks
from repro_torch.obs import telemetry as ttele

jax.config.update("jax_platform_name", "cpu")


def _x(seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4096) * 1e-3).astype(np.float32)
    x[rng.rand(4096) < 0.05] = 0.0
    return x


@pytest.mark.parametrize("backend", ["plain", "cuda", "cuda_fused"])
@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_health_metrics_match_jax_refresh(fmt, backend):
    target = float(js2.FMT_TARGET_MAX[fmt])
    x = _x(0)
    jst = jsb.init_site_state(telemetry=True)
    tst = tsb.init_site_state(telemetry=True)
    assert tmetrics.has_telemetry(tst) and set(tst) == set(jst)
    for step, scale in enumerate((1.0, 2.0 ** 12, 2.0 ** -9)):
        xx = x * np.float32(scale)
        jst = jsb.refresh_state(jnp.asarray(xx), jst, jnp.float32(step),
                                backend="ref", fmt=fmt, target_max=target)
        tst = tsb.refresh_state(torch.from_numpy(xx), tst, float(step),
                                backend=backend, target_max=target)
        got = {k: v.item() for k, v in tst.items()}
        want = {k: float(v) for k, v in jst.items()}
        count = float((xx != 0).sum())
        for f in ("sat_frac", "uflow_frac"):
            assert abs(got[f] - want[f]) <= 2.0 / count, (step, f)
        for f in ("alpha", "beta", "ema_mu", "ema_m"):
            assert got[f] == pytest.approx(want[f], rel=2e-6), (step, f)
        assert got["last"] == want["last"] == step
        assert got["qmse"] == pytest.approx(want["qmse"], rel=1e-5)
        assert got["qsnr_db"] == pytest.approx(want["qsnr_db"], abs=1e-4)
        for f in ("drift_mu", "drift_m"):
            assert got[f] == pytest.approx(want[f], abs=1e-5), (step, f)
        if step == 0:                 # bootstrap: fresh stats, no drift
            assert got["sat_frac"] == 0.0 and got["drift_mu"] == 0.0
            assert 0.0 <= got["uflow_frac"] < tdoctor.UFLOW_THRESH
            assert got["qsnr_db"] > 10.0
        if step == 1:                 # measured with the carried pair
            assert got["sat_frac"] > 0.0 and got["drift_mu"] > 0.0


def test_steady_site_state_keeps_telemetry_leaves():
    """A refresh that is not due passes the state (health leaves and all)
    through: ``maybe_refresh`` returns no new state."""
    st = tsb.init_site_state(telemetry=True)
    ab, new = tsb.maybe_refresh(torch.ones(4), st, False, 3.0,
                                tsb.StatsConfig(telemetry=True), 15.0)
    assert new is None and ab.tolist() == [1.0, 0.0]


def test_ensure_and_strip_telemetry_roundtrip():
    plain = {"s": {"fwd": tsb.init_site_state(),
                   "bwd": tsb.init_site_state(length=3)}}
    wide = tmetrics.ensure_telemetry(plain)
    for d in ("fwd", "bwd"):
        assert tmetrics.has_telemetry(wide["s"][d])
    assert wide["s"]["bwd"]["sat_frac"].shape == (3,)
    assert tmetrics.ensure_telemetry(wide)["s"]["fwd"].keys() == \
        wide["s"]["fwd"].keys()
    back = tmetrics.strip_telemetry(wide)
    assert sorted(back["s"]["fwd"]) == sorted(tsb.STATE_FIELDS)
    assert tmetrics.TELE_FIELDS == jmetrics.TELE_FIELDS


def test_resolve_fmt():
    for target_max in (8.0, 15.0, 12.345):
        assert (tmetrics.resolve_fmt(target_max)
                == jmetrics.resolve_fmt(None, target_max))


def _bank_pair():
    """One bank with a scalar and a [3]-row site, as JAX arrays and as the
    port's tensors."""
    rng = np.random.RandomState(3)

    def st(shape):
        s = {f: np.asarray(rng.rand(*shape), np.float32)
             for f in jsb.STATE_FIELDS + jmetrics.TELE_FIELDS}
        s["last"] = np.array(rng.choice([-1.0, 2.0, 5.0], size=shape),
                             np.float32)
        return s

    np_bank = {"a": {"fwd": st(()), "bwd": st(())},
               "seg0:dense/t0": {"fwd": st((3,)), "bwd": st((3,))},
               "plain": {"fwd": {f: np.float32(1.0)
                                 for f in jsb.STATE_FIELDS}}}
    return (jax.tree_util.tree_map(jnp.asarray, np_bank),
            convert.state_from_jax(np_bank, "cpu"))


def test_telemetry_records_match_jax():
    jbank, tbank = _bank_pair()
    jrec = list(jtele.state_records(jax.device_get(
        jtele.telemetry_state(jbank, 6)), 6))
    trec = list(ttele.state_records(ttele.to_host(
        ttele.telemetry_state(tbank, 6)), 6))
    assert trec == jrec
    assert {r["layer"] for r in trec} == {None, 0, 1, 2}
    assert "plain" not in {r["site"] for r in trec}
    assert ttele.telemetry_state({"p": tbank["plain"]}, 1) == {}


def test_jsonl_and_csv_sinks(tmp_path):
    path = str(tmp_path / "m.jsonl")
    s = tsinks.JsonlSink(path)
    s.emit({"kind": "train_step", "step": 0, "loss": np.float32(1.5)})
    s.emit({"kind": "site_health", "step": 0, "site": "a",
            "sat_frac": torch.tensor(0.25)})
    s.close()
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    assert recs[0]["loss"] == 1.5 and isinstance(recs[0]["loss"], float)
    assert recs[1]["sat_frac"] == 0.25
    path = str(tmp_path / "m.csv")
    s = tsinks.CsvSink(path)
    s.emit({"kind": "train_step", "step": 0, "loss": 1.0})
    s.emit({"kind": "site_health", "step": 0, "site": "a", "sat_frac": 0.0})
    s.close()
    with open(path) as f:
        header = f.readline().strip().split(",")
    assert header == ["kind", "step", "loss", "site", "sat_frac"]


_CONSOLE_RECORDS = [
    {"kind": "train_step", "step": 7, "loss": 1.2345, "lr": 3e-3,
     "step_ms": 12.0},
    {"kind": "train_step", "step": 8, "loss": 1.0, "lr": 3e-3},
    {"kind": "event", "event": "watchdog", "step": 9, "dt_s": 1.0,
     "median_s": 0.1, "factor": 3.0},
    {"kind": "event", "event": "checkpoint_saved", "step": 4,
     "blocking_s": 0.01, "write_s": 0.25},
    {"kind": "site_health", "step": 4, "site": "s", "dir": "a.fwd",
     "layer": None, "sat_frac": 0.5, "uflow_frac": 0.0, "qsnr_db": 20.0,
     "staleness": 2.0},
    {"kind": "site_health", "step": 4, "site": "s", "dir": "a.bwd",
     "layer": 2, "sat_frac": 0.5, "uflow_frac": 0.125, "qsnr_db": 20.0,
     "staleness": -1.0},
    {"kind": "event", "event": "guard_tripped", "step": 5, "trip": 1,
     "cause": "forced", "loss": 2.0, "grad_norm": float("nan")},
    {"step": 1, "x": 2},
]


def test_console_sink_prints_the_references_lines():
    tlines, jlines = [], []
    ts, js = tsinks.ConsoleSink(tlines.append), jsinks.ConsoleSink(
        jlines.append)
    for r in _CONSOLE_RECORDS:
        ts.emit(r)
        js.emit(r)
    assert tlines == jlines
    assert tlines[0] == "step     7 loss 1.2345 lr 3.00e-03 t 12ms"


def test_make_sink_and_tee(tmp_path):
    assert isinstance(tobs.make_sink(None), tsinks.NullSink)
    assert isinstance(tobs.make_sink("null"), tsinks.NullSink)
    assert isinstance(tobs.make_sink("console"), tsinks.ConsoleSink)
    assert isinstance(tobs.make_sink("memory"), tsinks.MemorySink)
    j = tobs.make_sink(f"jsonl:{tmp_path}/a.jsonl")
    assert isinstance(j, tsinks.JsonlSink)
    j.close()
    assert isinstance(tobs.make_sink(f"csv:{tmp_path}/a.csv"),
                      tsinks.CsvSink)
    with pytest.raises(ValueError, match="unknown metrics sink"):
        tobs.make_sink("protobuf:/tmp/x")
    a, b = tsinks.MemorySink(), tsinks.MemorySink()
    t = tsinks.TeeSink(a, b)
    t.emit({"kind": "event", "event": "x"})
    t.close()
    assert a.records == b.records and len(a.records) == 1
    assert a.by_kind("event") == a.records


# ---------------------------------------------------------------------------
# doctor
# ---------------------------------------------------------------------------

def _toy_loss(p, b, pol):
    return torch.sum(pol.dot(b, p["w"]) ** 2), {}


def test_doctor_flags_saturating_site():
    pol = make_policy("s2fp8_e4m3", "plain", "fig4")
    g = torch.Generator().manual_seed(1)
    params = {"w": torch.randn(16, 8, generator=g) * 0.1}
    batch = torch.randn(8, 16, generator=g)
    cfg = tsb.StatsConfig(refresh_every=16)
    bank = tsb.init_bank(_toy_loss, params, batch, pol, cfg)
    warm, loss = tdoctor.probe_bank(_toy_loss, params, batch, pol, bank,
                                    cfg, step=0)
    assert not tmetrics.has_telemetry(next(iter(bank.values()))["fwd"])
    rows = tdoctor.site_report(warm, step=0, refresh_every=16)
    assert rows and all(tdoctor.is_clean(r) for r in rows), rows
    assert all(r["recommend"] == "e4m3" for r in rows)
    assert np.isfinite(loss)
    hot, _ = tdoctor.probe_bank(_toy_loss, params, batch * 2.0 ** 12, pol,
                                warm, cfg, step=1)
    rows = tdoctor.site_report(hot, step=1, refresh_every=16)
    worst = rows[0]
    assert worst["sat_frac"] > 0.0 and "SAT" in worst["flags"]
    assert worst["recommend"] == "e5m2" and not tdoctor.is_clean(worst)
    report = tdoctor.format_report(rows, backend="plain", loss=1.0)
    assert "verdict: worst site" in report and "SAT" in report
    assert not params["w"].requires_grad      # the probe leaves params be


def test_doctor_probes_a_cold_bank_clean():
    pol = make_policy("s2fp8_e4m3", "plain", "fig4")
    params = {"w": torch.ones(4, 4) * 0.5}
    batch = torch.ones(4, 4)
    cfg = tsb.StatsConfig(refresh_every=8)
    bank = tsb.init_bank(_toy_loss, params, batch, pol, cfg)
    probed, _ = tdoctor.probe_bank(_toy_loss, params, batch, pol, bank, cfg)
    rows = tdoctor.site_report(probed, step=0, refresh_every=8)
    assert rows and all(tdoctor.is_clean(r) for r in rows)


def test_doctor_report_matches_jax():
    jbank, tbank = _bank_pair()
    jrows = jdoctor.site_report(jbank, step=9, refresh_every=2)
    trows = tdoctor.site_report(tbank, step=9, refresh_every=2)
    assert trows == jrows
    assert {r["flags"] and r["flags"][0] for r in trows} >= {"COLD"}
    for top in (3, 10):
        assert tdoctor.format_report(trows, backend="x", loss=0.5,
                                     top=top) == \
            jdoctor.format_report(jrows, backend="x", loss=0.5, top=top)
    assert tdoctor.format_report([]) == jdoctor.format_report([])
    base = {"sat_frac": 0.0, "uflow_frac": 0.0}
    for row in (base, {**base, "sat_frac": 0.01},
                {**base, "uflow_frac": tdoctor.UFLOW_THRESH + 0.01}):
        assert tdoctor.recommend_fmt(row) == jdoctor.recommend_fmt(row)
