"""The port's MoE training slice against the JAX package, on the CPU.

Reduced deepseek_moe_16b (3 layers: dense_first + 2 moe, d 128, 8
experts top-2, 2 shared experts, vocab 512, remat), batch 4 x 64 of the
Markov stream, AdamW at a constant 3e-3, s2fp8 with the StatsBank at
k = 4, 24 steps, from the same params (``convert.params_from_jax``) and
the same batches (drawn by JAX, fed as numpy), against the JAX ``ref``
engine on the payload GEMM path (``make_policy("s2fp8", backend="ref",
gemm_mode="payload")``).  Each MoE layer runs its three expert einsums
through the batched payload GEMM on both sides.

Bounds on the per-step |port - JAX| loss and aux, and why.  With f32
activations under fp32 the two packages' losses agree to 1.4e-6 at step 0
and the aux exactly (checked on the CPU from the same params and
batch), so the model is the same function.
With the model's bf16 activations the frameworks round bf16 after GEMMs
summed in other orders, and torch's log2/exp2 differ from XLA's in the
last ulp, which flips rare S2FP8 codes; in an MoE such a difference can
also move a token whose two best experts nearly tie to another expert,
which changes that token's output outright (step 0 already differs by
0.0036 in loss, 1.2e-4 in aux), and the differences compound over the
AdamW steps.  Measured over the 24 steps: loss largest 0.039, mean 0.013
(the dense quickstart's s2fp8 + bank: 0.021 / 0.0066); aux largest 0.006,
mean 0.0018 (aux is about 0.05).  Held to twice that: loss 0.08 / 0.03,
aux 0.012 / 0.004.

Also here: ``init_bank`` finds the reference's sites (the expert einsums
under ``seg{i}:moe/moe/qt{n}``, the shared experts under ``.../moe/mlp``),
``params_from_jax`` carries the MoE tree, remat replays each MoE layer
with the forward's routing and stats (the same bits, also when the
backward runs on another thread), and the launcher trains the reduced
model with a depth cut.
"""
import dataclasses
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

STEPS, K_EVERY = 24, 4
LOSS_BOUND = (0.08, 0.03)        # largest, mean |port - JAX| per step
AUX_BOUND = (0.012, 0.004)
JCFG = jax_reduced_config("deepseek_moe_16b")
TCFG = get_reduced_config("deepseek_moe_16b")


def _jax_loss(params, batch, pol):
    return jtlm.loss_fn(params, batch["tokens"], batch["labels"], JCFG, pol)


def _port_loss(params, batch, pol):
    return tlm.loss_fn(params, batch["tokens"], batch["labels"], TCFG, pol)


@pytest.fixture(scope="module")
def curves():
    table = jsyn.make_markov_table(0, JCFG.vocab)
    batches = [jax.device_get(jsyn.lm_batch(0, s, 4, 64, JCFG.vocab, table))
               for s in range(STEPS)]
    tbatches = [{k: torch.from_numpy(np.array(v)).long()
                 for k, v in b.items()} for b in batches]
    params0 = jtlm.init_lm(JCFG, jax.random.PRNGKey(0))
    cfg = jsb.StatsConfig(refresh_every=K_EVERY)
    pol = jax_policy("s2fp8", backend="ref", gemm_mode="payload")
    opt = jopt.adamw()
    params, state = params0, opt.init(params0)
    bank = jsb.init_bank(_jax_loss, params, batches[0], pol, cfg)
    step = jax.jit(jax_train_step(_jax_loss, opt, jsched.constant(3e-3), pol,
                                  stats=cfg))
    jl, ja = [], []
    for s in range(STEPS):
        params, state, bank, m = step(params, state, bank, batches[s],
                                      jnp.int32(s))
        jl.append(float(m["loss"]))
        ja.append(float(m["aux"]))

    pol = make_policy("s2fp8", "plain", "payload")
    opt = topt.adamw()
    params = params_from_jax(jax.device_get(params0), device="cpu")
    state = opt.init(params)
    tcfg = tsb.StatsConfig(refresh_every=K_EVERY)
    bank = tsb.init_bank(_port_loss, params, tbatches[0], pol, tcfg)
    step = ttrainer.make_train_step(_port_loss, opt, tsched.constant(3e-3),
                                    pol, stats=tcfg)
    tl, ta = [], []
    for s in range(STEPS):
        params, state, bank, m = step(params, state, bank, tbatches[s], s)
        tl.append(float(m["loss"]))
        ta.append(float(m["aux"]))
    return np.array(jl), np.array(tl), np.array(ja), np.array(ta)


def test_moe_training_tracks_jax_ref_engine(curves):
    jl, tl, ja, ta = curves
    assert np.all(np.isfinite(tl)) and np.all(np.isfinite(ta))
    d = np.abs(jl - tl)
    largest, mean = LOSS_BOUND
    assert d.max() <= largest and d.mean() <= mean, (d.max(), d.mean())
    d = np.abs(ja - ta)
    largest, mean = AUX_BOUND
    assert d.max() <= largest and d.mean() <= mean, (d.max(), d.mean())
    assert np.all(ta > 0)
    # the model learns: the last 4 steps' mean loss is below the first 4's
    assert tl[-4:].mean() < tl[:4].mean() - 0.1, tl


def test_init_bank_discovers_the_reference_moe_sites():
    params = jtlm.init_lm(JCFG, jax.random.PRNGKey(1))
    tokens = np.zeros((2, 16), np.int32)
    jbank = jsb.init_bank(
        lambda p, b, pol: jtlm.loss_fn(p, b, b, JCFG, pol), params,
        jnp.asarray(tokens), jax_policy("s2fp8", backend="ref",
                                        gemm_mode="payload"),
        jsb.StatsConfig())
    tbank = tsb.init_bank(
        lambda p, b, pol: tlm.loss_fn(p, b, b, TCFG, pol),
        params_from_jax(jax.device_get(params), device="cpu"),
        torch.from_numpy(tokens).long(), make_policy("s2fp8", "plain", "payload"),
        tsb.StatsConfig())

    def shapes(bank):
        return {k: {d: {f: tuple(np.shape(v)) for f, v in st.items()}
                    for d, st in e.items()} for k, e in bank.items()}

    assert shapes(tbank) == shapes(jbank)
    assert {"seg1:moe/moe/qt0", "seg1:moe/moe/qt1", "seg1:moe/moe/qt2",
            "seg1:moe/moe/mlp/qt0", "seg0:dense_first/mlp/qt0"} <= set(tbank)
    assert tbank["seg1:moe/moe/qt0"]["a.fwd"]["last"].shape == (2,)


def test_params_from_jax_carries_the_moe_tree():
    params = jax.device_get(jtlm.init_lm(JCFG, jax.random.PRNGKey(2)))
    tparams = params_from_jax(params, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(params)
    tleaves = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), tparams))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, a), (_, b) in zip(jleaves, tleaves):
        np.testing.assert_array_equal(b, np.asarray(a))
    moe = tparams["segments"][1]["moe"]
    assert set(moe) == {"router", "we_gate", "we_up", "we_down", "shared"}
    assert tuple(moe["we_gate"].shape) == (2, 8, 128, 64)
    assert tuple(moe["shared"]["w_gate"].shape) == (2, 128, 128)
    assert tuple(tparams["segments"][0]["mlp"]["w_gate"].shape) == (1, 128,
                                                                      256)
    assert tuple(tparams["head"].shape) == (128, 512)
    # the port's own init makes the same tree
    own = tlm.init_lm(TCFG, seed=0, device="cpu")
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, own)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0,
                                                            tparams))
    assert all(tuple(a.shape) == tuple(b.shape) for a, b in zip(
        topt.tree_leaves(own), topt.tree_leaves(tparams)))


@pytest.mark.parametrize("routing", ["global", "grouped"])
def test_remat_replays_the_moe_layers_bit_for_bit(routing):
    """Remat replays each MoE layer in the backward: routing, site keys
    and refreshes included, so loss, gradients and the refreshed bank are
    the same bits with and without it — also when the backward runs on
    another thread, as PyTorch's autograd engine runs a CUDA backward."""
    def run(remat, backward_thread):
        cfg = TCFG.replace(remat=remat, moe=dataclasses.replace(
            TCFG.moe, routing=routing))
        pol = make_policy("s2fp8", "plain", "payload")
        params = tlm.init_lm(cfg, seed=3, device="cpu")
        chain = tsyn.markov_chain(3, cfg.vocab)
        gen = torch.Generator().manual_seed(3)
        warm, batch = (tsyn.lm_batch(chain, gen, 2, 64, "cpu")
                       for _ in range(2))

        def loss_fn(p, b, pol_):
            return tlm.loss_fn(p, b["tokens"], b["labels"], cfg, pol_)

        stats = tsb.StatsConfig(refresh_every=4)
        bank = tsb.init_bank(loss_fn, params, batch, pol, stats)
        leaves = topt.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with tsb.bind(bank, 0, stats) as sess:   # warm every site
            loss, _ = loss_fn(params, warm, pol)
            torch.autograd.grad(loss, leaves)
        bank = tsb.merge_updates(bank, sess.updates)
        with tsb.bind(bank, 1, stats) as sess:   # a steady step
            loss, metrics = loss_fn(params, batch, pol)
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
        return ((loss.detach(), metrics["aux"].detach()), grads,
                [v for e in new.values() for st in e.values()
                 for v in st.values()])

    want = run(False, False)
    assert float(want[0][1]) > 0
    for backward_thread in (False, True):
        got = run(True, backward_thread)
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
        assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


def test_moe_launcher_trains_with_a_depth_cut(capsys):
    from repro_torch.launch import train
    train.main(["--arch", "deepseek_moe_16b", "--reduced", "--device", "cpu",
                "--n-layers", "2", "--steps", "3", "--batch", "2", "--seq",
                "32", "--stats-refresh-every", "2"])
    out = capsys.readouterr().out
    assert "[depth cut] deepseek-moe-16b: 3 -> 2 layers, pattern " \
           "('dense_first', 'moe')" in out
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith("{")]
    assert [r["step"] for r in lines] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and r["aux"] > 0 for r in lines)
    with pytest.raises(ValueError):
        train.cut_depth(TCFG, 5)
