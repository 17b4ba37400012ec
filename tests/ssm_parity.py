"""Shared by the port's SSM test modules (tests/test_torch_mamba2.py,
test_torch_mamba_train.py, test_torch_mamba2_train.py): the reference's
per-head scans in JAX, per-head scan inputs, a JAX / port config pair
with the JAX params, and the s2fp8 + bank loss curves of both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.core import statsbank as jsb
from repro.core.policy import make_policy as jax_policy
from repro.data import synthetic as jsyn
from repro.launch import api as japi
from repro.models import blocks as jblocks
from repro.models import transformer as jtlm
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.training.trainer import make_train_step as jax_train_step
from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.core import statsbank as tsb
from repro_torch.core.policy import make_policy
from repro_torch.models import transformer as tlm
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.training import trainer as ttrainer


def head_inputs(b, s, nh, hd, n, seed=11):
    """A per-head scan's inputs, as mamba2_apply makes them: x [b, s, nh
    hd], dt [b, s, nh] through softplus, B, C [b, s, n], A = -(1..16)
    spread over the heads, D [nh]."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, nh * hd)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)) - 1.0)
                  ).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    a = -np.linspace(1.0, 16.0, nh).astype(np.float32)
    d = rng.standard_normal(nh).astype(np.float32)
    return x, dt, bm, cm, a, d


def jax_step_scan(x, dt, bm, cm, a, d):
    """The reference's mamba2 scan (blocks.py:724-738): ``lax.scan`` of
    its step over the sequence, then ``+ d_skip x`` -> (y [b, s, di], h
    [b, nh, hd, n])."""
    b, s, di = x.shape
    nh, n = a.shape[0], bm.shape[-1]
    xpart = x.reshape(b, s, nh, di // nh)

    def step(h, inp):
        xt, dtt, bt, ct = inp
        da = jnp.exp(dtt * a)
        h = h * da[:, :, None, None] + jnp.einsum(
            "bhp,bn->bhpn", dtt[:, :, None] * xt, bt)
        return h, jnp.einsum("bhpn,bn->bhp", h, ct)

    h0 = jnp.zeros((b, nh, di // nh, n), jnp.float32)
    xs = (jnp.moveaxis(xpart, 1, 0), jnp.moveaxis(dt, 1, 0),
          jnp.moveaxis(bm, 1, 0), jnp.moveaxis(cm, 1, 0))
    hn, ys = jax.lax.scan(step, h0, xs)
    y = jnp.moveaxis(ys, 0, 1) + d[:, None] * xpart
    return y.reshape(b, s, di), hn


def jax_ssd_scan(x, dt, bm, cm, a, d):
    """The reference's "ssd" schedule (``_ssd_chunked``, chunks of 64),
    then ``+ d_skip x``."""
    b, s, di = x.shape
    nh = a.shape[0]
    xpart = x.reshape(b, s, nh, di // nh)
    y, hn = jblocks._ssd_chunked(xpart, dt, bm, cm, a, chunk=64)
    return (y + d[:, None] * xpart).reshape(b, s, di), hn


def pair(arch, **kw):
    cfg_j = jax_reduced_config(arch).replace(**kw)
    cfg = get_reduced_config(arch).replace(**kw)
    return cfg_j, cfg, jax.device_get(japi.init_params(
        cfg_j, jax.random.PRNGKey(0)))


STEPS, K_EVERY = 24, 4
# (largest, mean) per-step |port - JAX| loss: about twice the larger of
# two draws (tests/test_torch_mamba_train.py's curve test has the readings
# and the reasons)
TRAIN_BOUNDS = {"falcon_mamba_7b": (0.14, 0.045),
                "zamba2_1p2b": (0.12, 0.03)}


def check_curve(arch):
    jl, tl = curves(arch)
    assert np.all(np.isfinite(tl))
    d = np.abs(jl - tl)
    largest, mean = TRAIN_BOUNDS[arch]
    assert d.max() <= largest and d.mean() <= mean, (d.max(), d.mean())
    # the model learns: the last 4 steps' mean loss is below the first 4's
    assert tl[-4:].mean() < tl[:4].mean() - 0.1, tl


def curves(arch):
    """(JAX losses, port losses) of STEPS steps of reduced ``arch`` at
    batch 4 x 64 of the Markov stream, s2fp8 payload with the StatsBank at
    k = K_EVERY, AdamW at a constant 3e-3, from the same params and
    batches, the JAX ``ref`` engine against the port's plain engine; no
    remat on either side (remat changes no bits:
    ``test_remat_replay_reads_the_reference_sites_and_bits``)."""
    cfg_j, cfg, p0 = pair(arch, remat=False)
    table = jsyn.make_markov_table(0, cfg_j.vocab)
    batches = [jax.device_get(jsyn.lm_batch(0, s, 4, 64, cfg_j.vocab,
                                            table)) for s in range(STEPS)]

    def jloss(params, batch, pol):
        return jtlm.loss_fn(params, batch["tokens"], batch["labels"], cfg_j,
                            pol)

    def tloss(params, batch, pol):
        return tlm.loss_fn(params, batch["tokens"], batch["labels"], cfg, pol)

    stats = jsb.StatsConfig(refresh_every=K_EVERY)
    pol = jax_policy("s2fp8", backend="ref", gemm_mode="payload")
    opt = jopt.adamw()
    params, state = p0, opt.init(p0)
    bank = jsb.init_bank(jloss, params, batches[0], pol, stats)
    step = jax.jit(jax_train_step(jloss, opt, jsched.constant(3e-3), pol,
                                  stats=stats))
    jl = []
    for s in range(STEPS):
        params, state, bank, m = step(params, state, bank, batches[s],
                                      jnp.int32(s))
        jl.append(float(m["loss"]))

    tb = [{k: torch.from_numpy(np.array(v)).long() for k, v in b.items()}
          for b in batches]
    pol = make_policy("s2fp8", "plain", "payload")
    opt = topt.adamw()
    params = convert.params_from_jax(p0, device="cpu")
    state = opt.init(params)
    tstats = tsb.StatsConfig(refresh_every=K_EVERY)
    bank = tsb.init_bank(tloss, params, tb[0], pol, tstats)
    step = ttrainer.make_train_step(tloss, opt, tsched.constant(3e-3), pol,
                                    stats=tstats)
    tl = []
    for s in range(STEPS):
        params, state, bank, m = step(params, state, bank, tb[s], s)
        tl.append(float(m["loss"]))
    return np.array(jl), np.array(tl)


def check_model_gradients(arch):
    """fp32 with f32 activations, remat on both sides, 2 x 64 tokens: the
    loss within 1e-5 relative and every leaf's gradient within rtol 2e-3,
    atol 2e-4 of its largest entry against ``jax.grad`` of the reference's
    ``loss_fn`` (the same function; the scans' and GEMMs' sums run in
    other orders)."""
    cfg_j, cfg, p_j = pair(arch, activation_dtype="float32")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 65))
    x, y = toks[:, :-1], toks[:, 1:]
    pol_j = jax_policy("fp32")
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: jtlm.loss_fn(p, x, y, cfg_j, pol_j), has_aux=True))(p_j)
    params = convert.params_from_jax(p_j, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    lt, _ = tlm.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y),
                        cfg, make_policy("fp32"))
    gt = torch.autograd.grad(lt, leaves)
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    want = jax.tree_util.tree_leaves(gj)
    assert len(want) == len(gt)
    for i, (g, wj) in enumerate(zip(gt, want)):
        wj = np.asarray(wj)
        np.testing.assert_allclose(g.numpy(), wj, rtol=2e-3,
                                   atol=2e-4 * np.abs(wj).max(),
                                   err_msg=str(i))
