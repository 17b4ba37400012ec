"""The port's baseline training modes and stats utilities against the JAX
package, on the CPU.

The quickstart set-up of ``tests/test_torch_train.py`` (reduced minicpm_2b,
2 layers, vocab 64, no remat, batch 8 x 64 of the Markov stream, AdamW at
3e-3, 60 steps, the same params and batches on both sides) in the modes
``fp8_ls`` (raw e5m2 with the loss scaled by 100, paper Eq. 6) and
``bf16``, against the JAX ``ref`` trainer; fp8_ls's gradients against
fp8's; ``track_stats``; and ``statsbank.force_refresh``,
``statsbank.HostStatsBank``, ``backend.truncate_delayed`` and the
deprecated ``backend.DelayedStatsCache`` against the JAX ones.  Tolerances
are stated beside each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_reduced_config as jax_reduced_config
from repro.core import backend as jbackend
from repro.core import statsbank as jsb
from repro.core.policy import make_policy as jax_policy
from repro.data import synthetic as jsyn
from repro.models import transformer as jtlm
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.training.trainer import make_train_step as jax_train_step
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core import backend as tbackend
from repro_torch.core import statsbank as tsb
from repro_torch.core.policy import make_policy
from repro_torch.models import transformer as tlm
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.training import trainer as ttrainer

jax.config.update("jax_platform_name", "cpu")

STEPS = 60
# per-step |port - JAX| loss, largest and mean over the 60 steps: fp8_ls
# takes raw fp8's bounds of tests/test_torch_train.py, bf16 fp32's
BOUNDS = {"fp8_ls": (0.15, 0.06), "bf16": (0.03, 0.01)}
JCFG = jax_reduced_config("minicpm_2b").replace(n_layers=2, remat=False,
                                                vocab=64)
TCFG = get_reduced_config("minicpm_2b").replace(n_layers=2, remat=False,
                                                vocab=64)


def _jax_loss(params, batch, pol):
    return jtlm.loss_fn(params, batch["tokens"], batch["labels"], JCFG, pol)


def _port_loss(params, batch, pol):
    return tlm.loss_fn(params, batch["tokens"], batch["labels"], TCFG, pol)


def _policies(mode):
    return (jax_policy(mode, loss_scale=100.0, backend="ref",
                       gemm_mode="payload"),
            make_policy(mode, "plain", "payload", loss_scale=100.0))


@pytest.fixture(scope="module")
def quickstart():
    table = jsyn.make_markov_table(0, JCFG.vocab)
    batches = [jax.device_get(jsyn.lm_batch(0, s, 8, 64, JCFG.vocab, table))
               for s in range(STEPS)]
    tbatches = [{k: torch.from_numpy(np.array(v)).long()
                 for k, v in b.items()} for b in batches]
    params0 = jtlm.init_lm(JCFG, jax.random.PRNGKey(0))
    curves = {}
    for mode in BOUNDS:
        jpol, tpol = _policies(mode)
        opt = jopt.adamw()
        params, state = params0, opt.init(params0)
        step = jax.jit(jax_train_step(_jax_loss, opt, jsched.constant(3e-3),
                                      jpol))
        jl = []
        for s in range(STEPS):
            params, state, m = step(params, state, batches[s], jnp.int32(s))
            jl.append(float(m["loss"]))
        opt = topt.adamw()
        params = params_from_jax(jax.device_get(params0), device="cpu")
        state = opt.init(params)
        step = ttrainer.make_train_step(_port_loss, opt,
                                        tsched.constant(3e-3), tpol)
        tl = []
        for s in range(STEPS):
            params, state, m = step(params, state, tbatches[s], s)
            tl.append(float(m["loss"]))
        curves[mode] = (np.array(jl), np.array(tl))
    return curves


@pytest.mark.parametrize("mode", list(BOUNDS))
def test_quickstart_curve_tracks_jax_ref_trainer(quickstart, mode):
    """Per-step loss against the JAX trainer: fp8_ls within raw fp8's
    bounds, largest 0.15 and mean 0.06 (raw e5m2 without stats moves more
    when one code flips), bf16 within fp32's, 0.03 and 0.01 (no code: only
    bf16 roundings of f32 sums in another order)."""
    jl, tl = quickstart[mode]
    assert np.all(np.isfinite(tl))
    d = np.abs(jl - tl)
    largest, mean = BOUNDS[mode]
    assert d.max() <= largest and d.mean() <= mean, (d.max(), d.mean())


def _step0_grads(mode, scale=100.0):
    """Loss and gradients of the first train step (as the trainer takes
    them, unscaled) from the quickstart's params and batch 0, on both
    sides: (JAX loss, JAX leaves, port loss, port leaves)."""
    table = jsyn.make_markov_table(0, JCFG.vocab)
    batch = jax.device_get(jsyn.lm_batch(0, 0, 8, 64, JCFG.vocab, table))
    tbatch = {k: torch.from_numpy(np.array(v)).long()
              for k, v in batch.items()}
    params0 = jtlm.init_lm(JCFG, jax.random.PRNGKey(0))
    jpol = jax_policy(mode, loss_scale=scale, backend="ref")
    tpol = make_policy(mode, "plain", loss_scale=scale)
    captured = {}

    def capture_opt(real):
        def update(grads, state, params, lr):
            captured["grads"] = grads
            return real.update(grads, state, params, lr)
        return topt.Optimizer(real.init, update)

    sc = jpol.loss_scale if mode == "fp8_ls" else 1.0

    def jgrads(params):
        # the reference trainer's Eq. 6 (trainer.py:219-227, 340-342)
        loss, g = jax.value_and_grad(
            lambda p: _jax_loss(p, batch, jpol)[0] * sc)(params)
        return loss / sc, jax.tree_util.tree_map(lambda x: x / sc, g)

    jl, jg = jax.jit(jgrads)(params0)
    params = params_from_jax(jax.device_get(params0), device="cpu")
    topt_ = capture_opt(topt.adamw())
    step = ttrainer.make_train_step(_port_loss, topt_, tsched.constant(0.0),
                                    tpol)
    _, _, m = step(params, topt_.init(params), tbatch, 0)
    return (float(jl), [np.asarray(x) for x in jax.tree_util.tree_leaves(jg)],
            float(m["loss"]),
            [g.numpy() for g in tree_leaves(captured["grads"])])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_fp8_ls_truncates_the_scaled_cotangents():
    """Eq. 6: under fp8_ls the e5m2 truncations see the cotangents of the
    loss scaled by 100, so its unscaled gradients are not fp8's: e5m2
    flushes what falls below its smallest subnormal (2^-16), and the
    scaled cotangents lose less of it.  At the first step, from the same
    params and batch: the losses are the same function (fp8_ls's within
    1e-6 of fp8's, and within 1e-3 of the JAX trainer's); fp8 leaves more
    than 5x as many gradient entries exactly zero as fp8_ls, on both sides
    (measured: port 4,159 and 200, JAX 4,121 and 214 of 336,512), each
    count within 25% of the other side's; and the port's fp8_ls gradients
    are closer to the JAX trainer's fp8_ls gradients than to the port's
    own fp8 gradients (mean per-leaf ||a - b|| / ||b||, measured 0.19
    against 0.43).  Raw e5m2 gradients are noisy: one code moved by a sum
    in another order moves whole rows, so the two sides' fp8_ls leaves
    differ by 10-26% (fp8: 12-62%)."""
    jl, jg, tl, tg = _step0_grads("fp8_ls")
    fjl, fjg, fl, fg = _step0_grads("fp8")
    assert abs(fl - tl) <= 1e-6 * abs(fl), (fl, tl)
    assert abs(tl - jl) <= 1e-3, (tl, jl)

    def zeros(gs):
        return sum(int((g == 0).sum()) for g in gs)

    z = {"port": (zeros(tg), zeros(fg)), "jax": (zeros(jg), zeros(fjg))}
    for ls, f8 in z.values():
        assert f8 > 5 * ls, z
    for a, b in zip(z["port"], z["jax"]):
        assert abs(a - b) <= 0.25 * b, z
    to_jax = np.mean([_rel(t, j) for t, j in zip(tg, jg)])
    to_fp8 = np.mean([_rel(t, f) for t, f in zip(tg, fg)])
    assert to_jax < to_fp8, (to_jax, to_fp8)


def test_loss_scale_applies_only_to_fp8_ls():
    """The trainer reads ``loss_scale`` under fp8_ls only, as the
    reference: an fp8 policy with a loss scale trains as without."""
    _, _, l1, g1 = _step0_grads("fp8", scale=100.0)
    _, _, l2, g2 = _step0_grads("fp8", scale=1.0)
    assert l1 == l2 and all(np.array_equal(a, b) for a, b in zip(g1, g2))


def test_probe_stats_match_jax():
    """``track_stats``: (mu, m, alpha, beta) of the last gradient leaf in
    the reference's leaf order (sorted keys: the last segment's ``wv``),
    from the same params and batch in fp32: mu within 5e-3 and m within
    1e-4 (log2 units), alpha and beta within 1e-3 relative (measured 6.5e-4,
    5e-7, 1.7e-4 and 1.0e-4): with bf16 activations the two sides'
    gradients differ by ~1% an element (bf16 roundings of f32 sums in
    another order), which moves the mean log2 more than the max."""
    table = jsyn.make_markov_table(0, JCFG.vocab)
    batch = jax.device_get(jsyn.lm_batch(0, 0, 8, 64, JCFG.vocab, table))
    params0 = jtlm.init_lm(JCFG, jax.random.PRNGKey(0))
    jpol, tpol = _policies("fp32")
    jstep = jax.jit(jax_train_step(_jax_loss, jopt.adamw(),
                                   jsched.constant(3e-3), jpol,
                                   track_stats=True))
    opt = jopt.adamw()
    _, _, jm = jstep(params0, opt.init(params0), batch, jnp.int32(0))
    params = params_from_jax(jax.device_get(params0), device="cpu")
    topt_ = topt.adamw()
    step = ttrainer.make_train_step(_port_loss, topt_,
                                    tsched.constant(3e-3), tpol,
                                    track_stats=True)
    _, _, tm = step(params, topt_.init(params),
                    {k: torch.from_numpy(np.array(v)).long()
                     for k, v in batch.items()}, 0)
    assert set(tm["probe_stats"]) == set(jm["probe_stats"]) == {
        "mu", "m", "alpha", "beta"}
    for k, lim in (("mu", 5e-3), ("m", 1e-4)):
        assert abs(float(tm["probe_stats"][k])
                   - float(jm["probe_stats"][k])) <= lim, k
    for k in ("alpha", "beta"):
        want = float(jm["probe_stats"][k])
        assert abs(float(tm["probe_stats"][k]) - want) <= 1e-3 * abs(want)
    step = ttrainer.make_train_step(_port_loss, topt_,
                                    tsched.constant(3e-3), tpol)
    _, _, m = step(params, topt_.init(params),
                   {k: torch.from_numpy(np.array(v)).long()
                    for k, v in batch.items()}, 1)
    assert "probe_stats" not in m


def test_force_refresh_matches_jax():
    """Every cotangent-carrying site gets last = -1, read-only sites keep
    their entries, on a bank that mixes the three kinds; and after one
    step the port's train step refreshes every forced site (stats
    refreshed, every last = the step)."""
    bank_j = {
        "t0": {d: dict(jsb.init_site_state(), last=jnp.float32(4.0))
               for d in ("fwd", "bwd")},
        "seg0:dense/qt0": {d: dict(jsb.init_site_state(3),
                                   last=jnp.full((3,), 4.0))
                           for d in jsb.GEMM_DIRS},
        "q0": {"fwd": dict(jsb.init_site_state(), last=jnp.float32(4.0))},
    }
    bank_t = {k: {d: {f: torch.from_numpy(np.array(v)) for f, v in st.items()}
                  for d, st in e.items()} for k, e in bank_j.items()}
    fj, ft = jsb.force_refresh(bank_j), tsb.force_refresh(bank_t)
    for k in bank_j:
        for d in bank_j[k]:
            for f in bank_j[k][d]:
                assert np.array_equal(ft[k][d][f].numpy(),
                                      np.asarray(fj[k][d][f])), (k, d, f)
    assert ft["q0"] is bank_t["q0"]
    assert float(bank_t["t0"]["fwd"]["last"]) == 4.0     # not in place

    cfg = TCFG.replace(d_model=32, n_heads=2, kv_heads=2, head_dim=16,
                       d_ff=64)
    pol = make_policy("s2fp8", "plain", "payload")
    params = tlm.init_lm(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks, "labels": toks}

    def loss_fn(p, b, pol_):
        return tlm.loss_fn(p, b["tokens"], b["labels"], cfg, pol_)

    stats = tsb.StatsConfig(refresh_every=4)
    bank = tsb.init_bank(loss_fn, params, batch, pol, stats)
    opt = topt.adamw()
    state = opt.init(params)
    step = ttrainer.make_train_step(loss_fn, opt, tsched.constant(1e-3),
                                    pol, stats=stats)
    params, state, bank, m = step(params, state, bank, batch, 0)
    params, state, bank, m = step(params, state, bank, batch, 1)
    assert m["stats_refreshed"] == 0.0
    params, state, bank, m = step(params, state, tsb.force_refresh(bank),
                                  batch, 2)
    assert m["stats_refreshed"] == 1.0
    assert all(float(st["last"].min()) == 2.0 for e in bank.values()
               for st in e.values())


def _series(seed, n=5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((16, 24)) * 10.0 ** rng.uniform(-3, 1)
             ).astype(np.float32) for _ in range(n)]


def test_host_stats_bank_matches_jax():
    """``HostStatsBank`` (refresh every 2, EMA 0.5) over five tensors at one
    key and one at another: the same refresh steps (host decision), and
    the truncations and the quantized payloads of the JAX one within the
    per-op forward flip budget (elements beyond 1e-3 relative at most
    0.2%, none beyond 2% of max; codes at most one step apart in at most
    0.2%), the stored (alpha, beta) within 1e-5 relative (log2 sums in
    another order)."""
    jh = jsb.HostStatsBank(backend="ref", refresh_every=2, ema_decay=0.5)
    th = tsb.HostStatsBank(backend="plain", refresh_every=2, ema_decay=0.5)
    for step, x in enumerate(_series(1)):
        for key in ("a",) if step else ("a", "b"):
            jy = np.asarray(jh.truncate(jnp.asarray(x), key, step))
            ty = th.truncate(torch.from_numpy(x), key, step).numpy()
            d = np.abs(ty - jy)
            assert np.mean(d > 1e-3 * np.abs(jy)) <= 2e-3
            assert d.max() <= 0.02 * np.abs(jy).max()
            assert float(th.bank[key]["last"]) == float(jh.bank[key]["last"])
            for f in ("alpha", "beta"):
                want = float(jh.bank[key][f])
                assert abs(float(th.bank[key][f]) - want) <= 1e-5 * abs(want)
    assert [float(th.bank[k]["last"]) for k in ("a", "b")] == [4.0, 0.0]
    x = _series(2, 1)[0]
    jq = jh.quantize(jnp.asarray(x), "a", 5)
    tq = th.quantize(torch.from_numpy(x), "a", 5)
    jcodes = np.asarray(jq.payload).view(np.uint8).astype(np.int32)
    tcodes = tq.payload.view(torch.uint8).numpy().astype(np.int32)
    assert np.mean(jcodes != tcodes) <= 2e-3
    assert np.abs(jcodes - tcodes).max() <= 1
    assert th.stats("a") is not None and th.stats("zz") is None
    th.clear()
    assert not th.bank


def test_truncate_delayed_matches_jax():
    """Refresh, reuse, refresh: the stats used equal the JAX ones within
    1e-5 relative and the truncations within the forward flip budget;
    reused stats are the ones passed in, and ``stats=None`` refreshes."""
    xs = _series(3, 3)
    js = ts = None
    for i, (x, refresh) in enumerate(zip(xs, (True, False, True))):
        jy, js = jbackend.truncate_delayed(jnp.asarray(x), js,
                                           refresh=refresh, backend="ref")
        prev = ts
        ty, ts = tbackend.truncate_delayed(torch.from_numpy(x), ts,
                                           refresh=refresh, backend="plain")
        if not refresh:
            assert ts is prev
        jab = np.array([float(js[0]), float(js[1])])
        assert np.all(np.abs(ts.numpy() - jab) <= 1e-5 * np.abs(jab))
        d = np.abs(ty.numpy() - np.asarray(jy))
        assert np.mean(d > 1e-3 * np.abs(np.asarray(jy))) <= 2e-3, i
    _, fresh = tbackend.truncate_delayed(torch.from_numpy(xs[0]), None)
    assert fresh is not None


def test_delayed_stats_cache_is_a_deprecated_shim():
    """Constructing it warns with DeprecationWarning, as the JAX one does;
    it truncates as a HostStatsBank with its settings does, bit for bit,
    and keeps the old ``_stats`` / ``_last_refresh`` views."""
    with pytest.warns(DeprecationWarning, match="HostStatsBank"):
        cache = tbackend.DelayedStatsCache(backend="plain", refresh_every=3)
    with pytest.warns(DeprecationWarning):
        jbackend.DelayedStatsCache(backend="ref", refresh_every=3)
    host = tsb.HostStatsBank(backend="plain", refresh_every=3)
    for step, x in enumerate(_series(4, 4)):
        t = torch.from_numpy(x)
        assert torch.equal(cache.truncate(t, "w", step),
                           host.truncate(t, "w", step))
    assert cache._last_refresh == {"w": 3}
    alpha, beta = cache._stats["w"]
    assert torch.equal(alpha, host.bank["w"]["alpha"])
    cache.clear()
    assert cache._stats == {}
