"""The port's Fig. 4 GEMM mode (``gemm_mode="fig4"``) against the JAX
package, on the CPU.

Under fig4 every contraction is the paper's Fig. 4 chain: each operand and
the output truncated (and each cotangent, on the way back) with exact or
bank stats, around an f32 product.  Checked here: the policy's ``dot``,
``dot_general`` and ``einsum`` (a contraction the payload planner rejects
included), forward and gradients, against the JAX ``ref`` engine's fig4
chain; the bank sites a fig4 model visits; 24-step curves of the reduced
minicpm in fig4 mode (exact stats, and the StatsBank at k = 8) against the
JAX ``ref`` engine's; 4 steps on ``cuda_fused`` (the stats and fused
truncate kernels' plain versions) against the JAX ``pallas_fused`` engine
in interpret mode; and the launcher.

Tolerances.  Per op, the parity budget of ``tests/test_torch_train_nodes.
py``: an element agrees within 1e-3 relative, the others are flipped codes
(torch's log2/exp2 differ from XLA's in the last ulp): forward at most
0.2% flipped and none further than 2% of max|value|, gradients at most 2%
and 10%.  Curves: the bounds of ``tests/test_torch_train.py``'s s2fp8 run,
largest per-step |loss difference| 0.05 and mean 0.02.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_reduced_config as jax_reduced_config
from repro.core import statsbank as jsb
from repro.core.policy import make_policy as jax_policy
from repro.models import transformer as jtlm
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.training.trainer import make_train_step as jax_train_step
from repro_torch import kernels
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core import statsbank as tsb
from repro_torch.core.policy import make_policy
from repro_torch.data import synthetic as tsyn
from repro_torch.models import transformer as tlm
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.training import trainer as ttrainer

jax.config.update("jax_platform_name", "cpu")

FWD = (2e-3, 0.02)
GRAD = (2e-2, 0.1)


def _assert_close(got, want, budget, step):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got - want)
    flipped = np.mean(d > 1e-3 * np.abs(want))
    worst = d.max() / np.abs(want).max()
    assert flipped <= budget and worst <= step, (flipped, worst)


def test_fig4_policy_flags():
    pol = make_policy("s2fp8", "plain", "fig4")
    assert not pol.uses_payload_gemm
    assert make_policy("s2fp8", "cuda_fused").uses_payload_gemm
    assert not make_policy("s2fp8", "plain", "auto").uses_payload_gemm
    # fig4's flash attention is the reference's: q, k, v truncated, the
    # chunked flash attention, the output truncated (per-op forward budget)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 1, 1, 4, 8)).astype(np.float32)
    kv = rng.standard_normal((1, 1, 4, 8)).astype(np.float32)
    want = jax_policy("s2fp8", backend="ref", gemm_mode="fig4"
                      ).flash_attention(jnp.asarray(q), jnp.asarray(kv),
                                        jnp.asarray(kv))
    got = pol.flash_attention(torch.from_numpy(q), torch.from_numpy(kv),
                              torch.from_numpy(kv))
    _assert_close(got.numpy(), np.asarray(want), *FWD)
    with pytest.raises(ValueError):
        make_policy("s2fp8", "plain", "chain")


@pytest.mark.parametrize("mode", ["fp32", "fp8", "s2fp8", "s2fp8_e4m3"])
@pytest.mark.parametrize("gemm_mode", ["auto", "payload", "fig4"])
@pytest.mark.parametrize("engine,jax_engine", [
    ("plain", "ref"), ("cuda", "pallas"), ("cuda_fused", "pallas_fused"),
    ("auto", "pallas")])
def test_gemm_mode_resolves_as_the_reference(mode, gemm_mode, engine,
                                             jax_engine):
    """Each engine resolves the GEMM mode as its counterpart in the
    reference does: ``auto`` is fig4 on ``plain`` (the reference's
    ``ref``) and payload on the kernel engines (its Pallas ones); the
    port's ``auto`` engine is ``cuda``, the reference's pick on its
    accelerator."""
    got = make_policy(mode, engine, gemm_mode).uses_payload_gemm
    want = jax_policy(mode, backend=jax_engine,
                      gemm_mode=gemm_mode).uses_payload_gemm
    assert got == want


# (name, call on a policy, operand shapes, operand dtypes)
OPS = [
    ("dot", lambda p, a, b: p.dot(a, b), (4, 6, 32), (32, 24),
     ("bfloat16", "bfloat16")),
    ("dot_general_nt", lambda p, a, b: p.dot_general(
        a, b, (((2,), (1,)), ((), ()))), (2, 5, 32), (40, 32),
     ("bfloat16", "float32")),
    ("dot_general_batched", lambda p, a, b: p.dot_general(
        a, b, (((2,), (1,)), ((0,), (0,)))), (3, 8, 16), (3, 16, 12),
     ("float32", "float32")),
    ("einsum_attention", lambda p, a, b: p.einsum(
        "bkgqd,bksd->bkgqs", a, b), (2, 2, 2, 8, 16), (2, 2, 8, 16),
     ("bfloat16", "bfloat16")),
    ("einsum_rejected", lambda p, a, b: p.einsum("abd,dc->bac", a, b),
     (4, 6, 24), (24, 10), ("float32", "float32")),
    ("einsum_multi_label", lambda p, a, b: p.einsum("abc,abd->cd", a, b),
     (6, 5, 12), (6, 5, 9), ("float32", "float32")),
]


@pytest.mark.parametrize("name,call,ash,bsh,dts", OPS,
                         ids=[o[0] for o in OPS])
def test_fig4_ops_match_jax_ref(name, call, ash, bsh, dts):
    rng = np.random.default_rng(len(name))
    a = rng.standard_normal(ash).astype(np.float32)
    b = (rng.standard_normal(bsh) / np.sqrt(ash[-1])).astype(np.float32)
    jdt = [getattr(jnp, d) for d in dts]
    ja, jb = jnp.asarray(a).astype(jdt[0]), jnp.asarray(b).astype(jdt[1])
    jpol = jax_policy("s2fp8", backend="ref", gemm_mode="fig4")
    jy, vjp = jax.vjp(lambda x, y: call(jpol, x, y), ja, jb)
    g = (rng.standard_normal(jy.shape) * 1e-2).astype(np.float32)
    jda, jdb = vjp(jnp.asarray(g).astype(jy.dtype))

    tdt = [getattr(torch, d) for d in dts]
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).to(
        tdt[0]).requires_grad_()
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).to(
        tdt[1]).requires_grad_()
    ty = call(make_policy("s2fp8", "plain", "fig4"), ta, tb)
    assert str(ty.dtype).split(".")[-1] == str(jy.dtype)
    ty.backward(torch.from_numpy(g).to(ty.dtype))
    assert ta.grad.dtype == ta.dtype and tb.grad.dtype == tb.dtype
    _assert_close(ty.float().detach().numpy(),
                  np.asarray(jy.astype(jnp.float32)), *FWD)
    _assert_close(ta.grad.float().numpy(),
                  np.asarray(jda.astype(jnp.float32)), *GRAD)
    _assert_close(tb.grad.float().numpy(),
                  np.asarray(jdb.astype(jnp.float32)), *GRAD)


STEPS = 24
JCFG = jax_reduced_config("minicpm_2b").replace(n_layers=2, remat=False,
                                                vocab=64)
TCFG = get_reduced_config("minicpm_2b").replace(n_layers=2, remat=False,
                                                vocab=64)


def _jax_loss(params, batch, pol):
    return jtlm.loss_fn(params, batch["tokens"], batch["labels"], JCFG, pol)


def _port_loss(params, batch, pol):
    return tlm.loss_fn(params, batch["tokens"], batch["labels"], TCFG, pol)


def _shapes(bank):
    return {k: {d: {f: tuple(np.shape(v)) for f, v in st.items()}
                for d, st in e.items()} for k, e in bank.items()}


def test_fig4_bank_sites_match_the_reference():
    params = jtlm.init_lm(JCFG, jax.random.PRNGKey(0))
    tokens = np.zeros((2, 8), np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    jbank = jsb.init_bank(_jax_loss, params,
                          jax.tree_util.tree_map(jnp.asarray, batch),
                          jax_policy("s2fp8", backend="ref",
                                     gemm_mode="fig4"), jsb.StatsConfig())
    tbank = tsb.init_bank(_port_loss, params_from_jax(
        jax.device_get(params), device="cpu"),
        {k: torch.from_numpy(v).long() for k, v in batch.items()},
        make_policy("s2fp8", "plain", "fig4"), tsb.StatsConfig())
    assert _shapes(tbank) == _shapes(jbank)
    assert all(k.split("/")[-1].startswith("t") for k in tbank)


@functools.lru_cache(maxsize=None)
def _batches(steps):
    """Seeded Markov batches of 8 x 64 tokens, drawn once for the module
    (the port's sampler, handed to both sides)."""
    chain = tsyn.markov_chain(0, TCFG.vocab)
    gen = torch.Generator().manual_seed(0)
    return [tsyn.lm_batch(chain, gen, 8, 64, "cpu") for _ in range(steps)]


def _curve(jpol, tpol, k, steps):
    """Per-step losses of JAX and of the port from the same params and
    batches (the quickstart set-up), exact stats or the bank at k."""
    tb = _batches(STEPS)[:steps]
    batches = [{k_: v.numpy().astype(np.int32) for k_, v in b.items()}
               for b in tb]
    params0 = jtlm.init_lm(JCFG, jax.random.PRNGKey(0))
    opt = jopt.adamw()
    params, state, bank, cfg = params0, opt.init(params0), None, None
    if k:
        cfg = jsb.StatsConfig(refresh_every=k)
        bank = jsb.init_bank(_jax_loss, params, batches[0], jpol, cfg)
    step = jax.jit(jax_train_step(_jax_loss, opt, jsched.constant(3e-3),
                                  jpol, stats=cfg))
    jl = []
    for s in range(steps):
        if bank is None:
            params, state, m = step(params, state, batches[s], jnp.int32(s))
        else:
            params, state, bank, m = step(params, state, bank, batches[s],
                                          jnp.int32(s))
        jl.append(float(m["loss"]))

    opt = topt.adamw()
    params = params_from_jax(jax.device_get(params0), device="cpu")
    state, bank, cfg = opt.init(params), None, None
    if k:
        cfg = tsb.StatsConfig(refresh_every=k)
        bank = tsb.init_bank(_port_loss, params, tb[0], tpol, cfg)
    step = ttrainer.make_train_step(_port_loss, opt, tsched.constant(3e-3),
                                    tpol, stats=cfg)
    tl = []
    for s in range(steps):
        if bank is None:
            params, state, m = step(params, state, tb[s], s)
        else:
            params, state, bank, m = step(params, state, bank, tb[s], s)
        tl.append(float(m["loss"]))
    return np.array(jl), np.array(tl)


@pytest.mark.parametrize("k", [0, 8], ids=["exact", "bank_k8"])
def test_fig4_curve_tracks_jax_ref_engine(k):
    jl, tl = _curve(jax_policy("s2fp8", backend="ref", gemm_mode="fig4"),
                    make_policy("s2fp8", "plain", "fig4"), k, STEPS)
    assert np.all(np.isfinite(tl))
    d = np.abs(jl - tl)
    assert d.max() <= 0.05 and d.mean() <= 0.02, (d.max(), d.mean())


def test_cuda_fused_fig4_tracks_jax_pallas_fused():
    """Four steps of fig4 with exact stats: the port's ``cuda_fused``
    engine (every truncation the fused truncate's plain version) against
    the JAX ``pallas_fused`` engine (every truncation
    ``truncate_fused_pallas`` in interpret mode)."""
    kernels.reset_counts()
    jl, tl = _curve(jax_policy("s2fp8", backend="pallas_fused",
                               gemm_mode="fig4"),
                    make_policy("s2fp8", "cuda_fused", "fig4"), 0, 4)
    used = kernels.counts()
    assert used["truncate_fused"]["plain_calls"] > 0
    assert used["qmatmul_nn"]["plain_calls"] == 0     # no payload GEMM
    d = np.abs(jl - tl)
    assert np.all(np.isfinite(tl))
    assert d.max() <= 0.05 and d.mean() <= 0.02, (d.max(), d.mean())


def test_train_launcher_fig4_cuda_fused_on_cpu(capsys):
    from repro_torch.launch import train
    train.main(["--arch", "minicpm_2b", "--reduced", "--device", "cpu",
                "--backend", "cuda_fused", "--gemm-mode", "fig4",
                "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out.splitlines()
    assert "backend cuda_fused -> cuda_fused, gemm fig4, tf32 False" in out[0]
    lines = [json.loads(line) for line in out if line.startswith("{")]
    assert [r["step"] for r in lines] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in lines)
