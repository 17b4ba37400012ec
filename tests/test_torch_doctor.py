"""Slice 13: ``launch/doctor.py`` (s2fp8-doctor) against the reference's.

A checkpoint written by the JAX ``CheckpointManager`` — reduced
minicpm_2b's params, AdamW state and a JAX StatsBank (fig4 sites, made by
``init_bank``) — is read by the port's doctor on the ``plain`` engine and
by ``repro.launch.doctor``'s steps on ``ref``, both probing one batch (the
same numpy tokens).  Both give the same 224 (site, direction, layer) rows
and flags; the health metrics agree within SAT_TOL and UFLOW_TOL
(fractions of a tensor's elements; measured 0.0 and 0.0063, median
0.0006) and SNR_TOL_DB (measured 0.98 dB, median 0.08 dB).  They are not
equal: XLA's log2 differs from torch's in the last ulp, codes flip at
rounding boundaries, and the flips spread through the later layers
(ROADMAP queue 3, "parity is a budget").
A checkpoint whose bank has another site structure falls back to a cold
bank.  The reference's ``_restore`` without a step sends any checkpoint
whose first template does not match to quarantine and raises
FileNotFoundError (a telemetry-bearing bank, or another structure:
ROADMAP queue 3); the port's doctor reads the newest valid step by name.
"""
import os

import jax
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.base import get_reduced_config as jreduced
from repro.core import statsbank as jstatsbank
from repro.core.policy import make_policy as jmake_policy
from repro.launch import api as japi
from repro.launch import doctor as jdoctor
from repro.obs import doctor as jobs_doctor
from repro.optim import optimizers as joptim
from repro_torch.launch import doctor

SAT_TOL = 1e-3
UFLOW_TOL = 0.01
SNR_TOL_DB = 1.5
SNR_MEDIAN_TOL_DB = 0.2
B, S = 2, 32


def _tokens(seed):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """The JAX side writes params, AdamW state and a fig4 bank at step 3,
    and the same with a bank of another site structure."""
    cfg = jreduced("minicpm_2b")
    loss_fn = japi.make_loss_fn(cfg)
    params = japi.init_params(cfg, jax.random.PRNGKey(0))
    opt_state = joptim.adamw(weight_decay=0.01).init(params)
    base = jstatsbank.StatsConfig()
    pol = jmake_policy("s2fp8", backend="ref", gemm_mode="fig4")
    warm_batch = _tokens(1)
    fresh = jstatsbank.init_bank(loss_fn, params, warm_batch, pol, base)
    good = str(tmp_path_factory.mktemp("ck_fig4"))
    JManager(good).save(3, (params, opt_state, fresh))
    # a bank of another site structure: one site fewer
    other_bank = dict(fresh)
    other_bank.pop(sorted(other_bank)[0])
    other = str(tmp_path_factory.mktemp("ck_other"))
    JManager(other).save(3, (params, opt_state, other_bank))
    return good, other, cfg, loss_fn, params, opt_state, pol, base, fresh


def _port_probe(monkeypatch, ckpt_dir, batch):
    monkeypatch.setattr(doctor, "_data", lambda cfg, args, dev: {
        k: torch.as_tensor(v, dtype=torch.int64) for k, v in batch.items()})
    args = doctor.build_parser().parse_args([
        "--arch", "minicpm_2b", "--reduced", "--device", "cpu",
        "--backends", "plain", "--ckpt-dir", ckpt_dir])
    (got,) = doctor.probe(args)
    return got


def _key(r):
    return (r["site"], r["dir"], r["layer"])


def test_port_doctor_reads_a_jax_checkpoint_like_the_reference(
        jax_ckpt, monkeypatch):
    good, _, cfg, loss_fn, params, opt_state, pol, base, fresh = jax_ckpt
    batch = _tokens(2)
    port = _port_probe(monkeypatch, good, batch)
    assert port["restored"]
    # the reference's run() body on the same checkpoint and batch; its
    # step is named, since with step=None its first (telemetry-less)
    # template would send the checkpoint to quarantine (ROADMAP queue 3)
    p, _, bank, step = jdoctor._restore(good, 3, params, opt_state, fresh)
    assert bank is not None and step == 3
    probed, jloss = jobs_doctor.probe_bank(loss_fn, p, batch, pol, bank,
                                           base, step=step)
    jrows = {_key(r): r for r in jobs_doctor.site_report(probed, step=step)}
    prows = {_key(r): r for r in port["rows"]}
    assert set(prows) == set(jrows) and len(prows) > 50
    assert abs(port["loss"] - jloss) < 1e-3 * abs(jloss)
    snr = []
    for k, r in jrows.items():
        q = prows[k]
        assert abs(q["sat_frac"] - r["sat_frac"]) <= SAT_TOL, k
        assert abs(q["uflow_frac"] - r["uflow_frac"]) <= UFLOW_TOL, k
        snr.append(abs(q["qsnr_db"] - r["qsnr_db"]))
        assert snr[-1] <= SNR_TOL_DB, k
        assert q["flags"] == r["flags"] and q["last"] == r["last"], k
    assert float(np.median(snr)) <= SNR_MEDIAN_TOL_DB
    # the metrics are not trivial: most sites flush a few elements
    assert sum(r["uflow_frac"] > 0 for r in jrows.values()) > len(jrows) / 2


def test_a_bank_of_another_structure_falls_back_to_a_cold_bank(
        jax_ckpt, monkeypatch, capsys):
    _, other, *_ = jax_ckpt
    got = _port_probe(monkeypatch, other, _tokens(2))
    assert not got["restored"]
    assert "probing a cold bank" in capsys.readouterr().out
    # a cold bank bootstraps on the probe: every site reports clean
    assert got["rows"] and all(r["flags"] == [] for r in got["rows"])
    # the checkpoint is read, never quarantined
    assert sorted(os.listdir(other)) == ["step_0000000003"]


def test_smoke_on_the_plain_engine():
    assert doctor.main(["--smoke", "--device", "cpu", "--backends",
                        "plain"]) == 0
