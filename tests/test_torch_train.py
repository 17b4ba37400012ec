"""The port's training slice against the JAX package, on the CPU.

The quickstart configuration of ``examples/quickstart.py``: reduced
minicpm_2b with 2 layers and a 64-token vocabulary, no remat, batch 8 x 64
of the Markov stream, AdamW at a constant 3e-3, 60 steps, from the same
params (``convert.params_from_jax``) and the same batches (drawn by JAX,
fed as numpy).  Four runs — fp32, s2fp8 with exact per-call stats, raw
fp8, and s2fp8 with the StatsBank at k = 8 — each against the JAX ``ref``
engine on the payload GEMM path (``make_policy(mode, backend="ref",
gemm_mode="payload")``).

Bounds, measured here and stated with their margins.  The two frameworks
round bf16 activations after GEMMs summed in other orders, and torch's
log2/exp2 differ from XLA's in the last ulp, which flips rare S2FP8 codes;
the differences compound over 60 AdamW steps.  Per-step |port - JAX| loss,
largest and mean over the 60 steps: fp32 <= 0.03 / 0.01 (measured 0.0084
/ 0.0020), s2fp8 <= 0.05 / 0.02 (0.019 / 0.0067), s2fp8 + bank <= 0.05 /
0.02 (0.021 / 0.0066), fp8 <= 0.15 / 0.06 (0.061 / 0.023: raw e5m2
without stats rounds more, so a flip moves more).  On the mean loss of
the last 10 steps, in both packages: s2fp8 and s2fp8 + bank within 2% of
fp32 (measured 0.1-0.3%), and fp8 at least 0.02 above s2fp8 (measured
0.055-0.059): S2FP8 tracks FP32, raw FP8 does not (the paper's claim).
"""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.core import statsbank as jsb
from repro.core.policy import make_policy as jax_policy
from repro.data import synthetic as jsyn
from repro.models import transformer as jtlm
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.training.trainer import make_train_step as jax_train_step
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core import statsbank as tsb
from repro_torch.core.policy import make_policy
from repro_torch.data import synthetic as tsyn
from repro_torch.models import transformer as tlm
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.training import trainer as ttrainer
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

STEPS = 60
RUNS = {"fp32": ("fp32", 0), "s2fp8": ("s2fp8", 0), "fp8": ("fp8", 0),
        "s2fp8_bank": ("s2fp8", 8)}
BOUNDS = {"fp32": (0.03, 0.01), "s2fp8": (0.05, 0.02), "fp8": (0.15, 0.06),
          "s2fp8_bank": (0.05, 0.02)}
JCFG = jax_reduced_config("minicpm_2b").replace(n_layers=2, remat=False,
                                                vocab=64)
TCFG = get_reduced_config("minicpm_2b").replace(n_layers=2, remat=False,
                                                vocab=64)


def _jax_loss(params, batch, pol):
    return jtlm.loss_fn(params, batch["tokens"], batch["labels"], JCFG, pol)


def _port_loss(params, batch, pol):
    return tlm.loss_fn(params, batch["tokens"], batch["labels"], TCFG, pol)


@pytest.fixture(scope="module")
def quickstart():
    table = jsyn.make_markov_table(0, JCFG.vocab)
    batches = [jax.device_get(jsyn.lm_batch(0, s, 8, 64, JCFG.vocab, table))
               for s in range(STEPS)]
    tbatches = [{k: torch.from_numpy(np.array(v)).long()
                 for k, v in b.items()} for b in batches]
    params0 = jtlm.init_lm(JCFG, jax.random.PRNGKey(0))
    curves = {}
    for name, (mode, k) in RUNS.items():
        # JAX: the reference's ref engine on the payload GEMM path, with
        # the quickstart's policy (its loss_scale is read only by fp8_ls)
        pol = jax_policy(mode, loss_scale=100.0, backend="ref",
                         gemm_mode="payload")
        opt = jopt.adamw()
        params, state, bank, cfg = params0, opt.init(params0), None, None
        if k:
            cfg = jsb.StatsConfig(refresh_every=k)
            bank = jsb.init_bank(_jax_loss, params, batches[0], pol, cfg)
        step = jax.jit(jax_train_step(_jax_loss, opt, jsched.constant(3e-3),
                                      pol, stats=cfg))
        jl = []
        for s in range(STEPS):
            if bank is None:
                params, state, m = step(params, state, batches[s],
                                        jnp.int32(s))
            else:
                params, state, bank, m = step(params, state, bank,
                                              batches[s], jnp.int32(s))
            jl.append(float(m["loss"]))
        # the port, plain engine on the CPU
        pol = make_policy(mode, "plain", "payload")
        opt = topt.adamw()
        params = params_from_jax(jax.device_get(params0), device="cpu")
        state, bank, cfg = opt.init(params), None, None
        if k:
            cfg = tsb.StatsConfig(refresh_every=k)
            bank = tsb.init_bank(_port_loss, params, tbatches[0], pol, cfg)
        step = ttrainer.make_train_step(_port_loss, opt,
                                        tsched.constant(3e-3), pol,
                                        stats=cfg)
        tl = []
        for s in range(STEPS):
            if bank is None:
                params, state, m = step(params, state, tbatches[s], s)
            else:
                params, state, bank, m = step(params, state, bank,
                                              tbatches[s], s)
            tl.append(float(m["loss"]))
        curves[name] = (np.array(jl), np.array(tl))
    return curves


@pytest.mark.parametrize("run", list(RUNS))
def test_quickstart_curve_tracks_jax_ref_engine(quickstart, run):
    jl, tl = quickstart[run]
    assert np.all(np.isfinite(tl))
    d = np.abs(jl - tl)
    largest, mean = BOUNDS[run]
    assert d.max() <= largest and d.mean() <= mean, (d.max(), d.mean())


def test_s2fp8_tracks_fp32_and_fp8_does_not(quickstart):
    for side in (0, 1):                       # JAX, then the port
        tail = {r: c[side][-10:].mean() for r, c in quickstart.items()}
        assert tail["s2fp8"] <= 1.02 * tail["fp32"], tail
        assert tail["s2fp8_bank"] <= 1.02 * tail["fp32"], tail
        assert tail["fp8"] >= tail["s2fp8"] + 0.02, tail


def test_init_bank_discovers_the_reference_sites():
    cfg_j = jax_reduced_config("minicpm_2b").replace(n_layers=2, vocab=64)
    cfg_t = get_reduced_config("minicpm_2b").replace(n_layers=2, vocab=64)
    params = jtlm.init_lm(cfg_j, jax.random.PRNGKey(0))
    tokens = np.zeros((2, 8), np.int32)
    jbank = jsb.init_bank(
        lambda p, b, pol: jtlm.loss_fn(p, b, b, cfg_j, pol), params,
        jnp.asarray(tokens), jax_policy("s2fp8", backend="ref",
                                        gemm_mode="payload"),
        jsb.StatsConfig())
    tbank = tsb.init_bank(
        lambda p, b, pol: tlm.loss_fn(p, b, b, cfg_t, pol),
        params_from_jax(jax.device_get(params), device="cpu"),
        torch.from_numpy(tokens).long(), make_policy("s2fp8", "plain", "payload"),
        tsb.StatsConfig())
    assert {k: {d: {f: tuple(np.shape(v)) for f, v in st.items()}
                for d, st in e.items()} for k, e in tbank.items()} == \
        {k: {d: {f: tuple(np.shape(v)) for f, v in st.items()}
             for d, st in e.items()} for k, e in jbank.items()}
    assert all(float(st["last"].max()) == -1.0 for e in tbank.values()
               for st in e.values())


def test_refresh_decision_reads_the_device_only_after_refreshes(monkeypatch):
    """k = 3 over 7 steps: the cold-site map is read once for the first
    bank and once after each step that refreshed (0, 3, 6), never on a
    steady step."""
    cfg = TCFG.replace(d_model=32, n_heads=2, kv_heads=2, head_dim=16,
                       d_ff=64)
    pol = make_policy("s2fp8", "plain", "payload")
    params = tlm.init_lm(cfg, seed=0, device="cpu")
    chain = tsyn.markov_chain(0, cfg.vocab)
    gen = torch.Generator().manual_seed(0)
    batches = [tsyn.lm_batch(chain, gen, 2, 16, "cpu") for _ in range(8)]

    def loss_fn(p, b, pol_):
        return tlm.loss_fn(p, b["tokens"], b["labels"], cfg, pol_)

    stats = tsb.StatsConfig(refresh_every=3)
    bank = tsb.init_bank(loss_fn, params, batches[7], pol, stats)
    reads = []
    real = tsb.cold_sites
    monkeypatch.setattr(tsb, "cold_sites",
                        lambda b: reads.append(1) or real(b))
    opt = topt.adamw()
    state = opt.init(params)
    step = ttrainer.make_train_step(loss_fn, opt, tsched.constant(1e-3),
                                    pol, stats=stats)
    refreshed = []
    for s in range(7):
        before = len(reads)
        params, state, bank, m = step(params, state, bank, batches[s], s)
        refreshed.append(m["stats_refreshed"])
        assert len(reads) - before == (s == 0) + (s % 3 == 0), s
    assert refreshed == [1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 1.0]
    assert all(float(st["last"].min()) == 6.0 for e in bank.values()
               for st in e.values())


def test_remat_gives_the_same_loss_grads_and_bank():
    """Layer remat replays each layer's forward in the backward, sites and
    refreshes included: the step's loss, gradients and refreshed bank are
    the same bits with and without it — also when the backward runs on
    another thread, as PyTorch's autograd engine runs a CUDA backward (the
    replay must find the forward's session there)."""
    def run(remat, backward_thread):
        cfg = TCFG.replace(remat=remat)
        pol = make_policy("s2fp8", "plain", "payload")
        params = tlm.init_lm(cfg, seed=3, device="cpu")
        chain = tsyn.markov_chain(3, cfg.vocab)
        gen = torch.Generator().manual_seed(3)
        warm, batch = (tsyn.lm_batch(chain, gen, 2, 32, "cpu")
                       for _ in range(2))

        def loss_fn(p, b, pol_):
            return tlm.loss_fn(p, b["tokens"], b["labels"], cfg, pol_)

        stats = tsb.StatsConfig(refresh_every=4)
        bank = tsb.init_bank(loss_fn, params, batch, pol, stats)
        leaves = topt.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with tsb.bind(bank, 0, stats) as sess:   # warm every site on a batch
            loss, _ = loss_fn(params, warm, pol)
            torch.autograd.grad(loss, leaves)
        bank = tsb.merge_updates(bank, sess.updates)
        with tsb.bind(bank, 1, stats) as sess:   # a steady step on another
            loss, _ = loss_fn(params, batch, pol)
            if backward_thread:
                box = []
                worker = threading.Thread(target=lambda: box.append(
                    torch.autograd.grad(loss, leaves)))
                worker.start()
                worker.join(timeout=120)
                assert not worker.is_alive() and len(box) == 1
                grads = box[0]
            else:
                grads = torch.autograd.grad(loss, leaves)
        new = tsb.merge_updates(bank, sess.updates)
        return (loss.detach(), grads, [v for e in new.values()
                                       for st in e.values()
                                       for v in st.values()])

    want = run(False, False)
    for backward_thread in (False, True):
        got = run(True, backward_thread)
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
        assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


@pytest.mark.parametrize("name", ["adamw", "sgdm"])
def test_optimizers_match_reference(name):
    rng = np.random.default_rng(6)
    tree = {"w": rng.standard_normal((8, 5)).astype(np.float32),
            "layers": [{"b": rng.standard_normal(7).astype(np.float32)}]}
    grads = [jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 3).astype(np.float32),
        tree) for _ in range(3)]
    kw = dict(weight_decay=0.01, clip_norm=1.0)
    jo = (jopt.adamw if name == "adamw" else jopt.sgd_momentum)(**kw)
    to = (topt.adamw if name == "adamw" else topt.sgd_momentum)(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_jax(tree, device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                           jnp.float32(3e-3))
        tp, ts = to.update(params_from_jax(g, device="cpu"), ts, tp, 3e-3)
    for a, b in zip(jax.tree_util.tree_leaves(jp), topt.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    assert ts.step == 3
    norm = topt.global_norm(params_from_jax(grads[0], device="cpu"))
    np.testing.assert_allclose(float(norm), float(jopt.global_norm(
        jax.tree_util.tree_map(jnp.asarray, grads[0]))), rtol=1e-6)
    clipped, _ = topt.clip_by_global_norm(params_from_jax(grads[0],
                                                          device="cpu"), 1.0)
    np.testing.assert_allclose(float(topt.global_norm(clipped)), 1.0,
                               rtol=1e-5)


def test_schedules_match_reference():
    pairs = [(jsched.make_schedule("wsd", 3e-3, 100, 5),
              tsched.make_schedule("wsd", 3e-3, 100, 5)),
             (jsched.make_schedule("cosine", 3e-3, 100, 5),
              tsched.make_schedule("cosine", 3e-3, 100, 5)),
             (jsched.constant(3e-3), tsched.constant(3e-3))]
    for jf, tf in pairs:
        for s in (0, 1, 4, 5, 50, 79, 80, 81, 99, 100, 150):
            np.testing.assert_allclose(tf(s), float(jf(s)), rtol=1e-6)


def test_markov_data_matches_the_reference_chain():
    for vocab in (64, 1000):
        np.testing.assert_array_equal(tsyn.make_markov_table(0, vocab),
                                      np.asarray(jsyn.make_markov_table(
                                          0, vocab)))
    chain = tsyn.markov_chain(1, 64)
    a = tsyn.lm_batch(chain, torch.Generator().manual_seed(5), 4, 32, "cpu")
    b = tsyn.lm_batch(chain, torch.Generator().manual_seed(5), 4, 32, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["labels"].min()) >= 0 and int(a["labels"].max()) < 64
    # most transitions go to one of the token's 4 likely successors
    succ = torch.from_numpy(chain.succ)
    hit = (succ[a["tokens"]] == a["labels"][..., None]).any(-1)
    assert hit.float().mean() > 0.5


def test_eval_step_returns_the_loss_metrics_without_autograd():
    pol = make_policy("s2fp8", "plain", "payload")
    params = tlm.init_lm(TCFG, seed=1, device="cpu")
    for p in topt.tree_leaves(params):
        p.requires_grad_(True)
    batch = tsyn.lm_batch(tsyn.markov_chain(1, TCFG.vocab),
                          torch.Generator().manual_seed(1), 2, 16, "cpu")
    metrics = ttrainer.make_eval_step(_port_loss, pol)(params, batch)
    assert not metrics["nll"].requires_grad
    assert torch.equal(metrics["nll"],
                       _port_loss(params, batch, pol)[1]["nll"].detach())


def test_train_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import train
    train.main(["--arch", "minicpm_2b", "--reduced", "--device", "cpu",
                "--steps", "3", "--batch", "2", "--seq", "16",
                "--stats-refresh-every", "2"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [r["step"] for r in lines] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and r["step_ms"] > 0
               and r["tokens_per_s"] > 0 for r in lines)


def test_train_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "minicpm_2b", "--reduced", "--steps", "1"])
    chain = tsyn.markov_chain(0, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsyn.lm_batch(chain, torch.Generator(), 1, 4)
    assert tsyn.lm_batch(chain, torch.Generator(), 1, 4,
                         "cpu")["tokens"].device.type == "cpu"
