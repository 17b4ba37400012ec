"""Training the attention-family configs against the JAX package, on the
CPU: reduced gemma3_1b (``local`` blocks with window 64 at 96 tokens,
``gelu_glu``), nemotron_4_340b (``sq_relu``, layer norm) and
kimi_k2_1t_a32b (8 experts top-2 + 1 shared, a ``dense_first`` layer), 24
steps each at batch 4 of the Markov stream, s2fp8 payload with the
StatsBank at k = 4, AdamW at a constant 3e-3, from the same params
(``params_from_jax``) and batches (drawn by JAX), against the JAX ``ref``
engine.  Each config runs in its own test, in a module of its own beside
tests/test_torch_families.py, so that the suite's workers share them.

Bounds on the per-step |port - JAX| loss, and why: the two packages
compute the same function (tests/test_torch_families.py holds fp32
forwards within 1e-4), but torch's log2/exp2 differ from XLA's in the last
ulp, which flips rare S2FP8 codes, and bf16 sums run in other orders; the
differences compound over the AdamW steps (ROADMAP queue 3: 0.021 over the
quickstart's 60 steps; the reduced MoE's 0.039, where a token can move to
its other expert).  Measured here, largest / mean, on these params and
batches (seed 0) and on a second draw of both (seed 1): gemma3 0.011 /
0.0038 and 0.013 / 0.0047, nemotron 0.0089 / 0.0032 and 0.0082 / 0.0038,
kimi 0.047 / 0.016 and 0.053 / 0.020 (above deepseek's 0.039: 8 experts
top-2 with one shared expert move more tokens on a near tie).
``TRAIN_BOUNDS`` holds the dense configs to 0.025 / 0.01, about twice the
largest reading, and kimi to deepseek's 0.08 / 0.03
(tests/test_torch_moe_train.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_configs
from repro.core import statsbank as jsb
from repro.core.policy import make_policy as jax_policy
from repro.data import synthetic as jsyn
from repro.launch import api as japi
from repro.models import transformer as jtlm
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.training.trainer import make_train_step as jax_train_step
from repro_torch import convert
from repro_torch.configs import base as port_configs
from repro_torch.core import statsbank as tsb
from repro_torch.core.policy import make_policy
from repro_torch.models import transformer as tlm
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.training import trainer as ttrainer
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")


def _pair(arch):
    cfg_j = jax_configs.get_reduced_config(arch).replace(remat=False)
    cfg = port_configs.get_reduced_config(arch)
    return cfg_j, cfg, japi.init_params(cfg_j, jax.random.PRNGKey(0))


STEPS, K_EVERY = 24, 4
# (largest, mean) per-step |port - JAX| loss (the module docstring has the
# measured values and the reasons)
TRAIN_BOUNDS = {"gemma3_1b": (0.025, 0.01),
                "nemotron_4_340b": (0.025, 0.01),
                "kimi_k2_1t_a32b": (0.08, 0.03)}
TRAIN_SEQ = {"gemma3_1b": 96}          # past the window of 64


def _curves(arch):
    cfg_j, cfg, p0 = _pair(arch)
    seq = TRAIN_SEQ.get(arch, 64)
    table = jsyn.make_markov_table(0, cfg_j.vocab)
    batches = [jax.device_get(jsyn.lm_batch(0, s, 4, seq, cfg_j.vocab,
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
    params = convert.params_from_jax(jax.device_get(p0), device="cpu")
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


@pytest.mark.parametrize("arch", sorted(TRAIN_BOUNDS))
def test_training_tracks_jax_ref_engine(arch):
    jl, tl = _curves(arch)
    assert np.all(np.isfinite(tl))
    d = np.abs(jl - tl)
    largest, mean = TRAIN_BOUNDS[arch]
    assert d.max() <= largest and d.mean() <= mean, (d.max(), d.mean())
    # the model learns: the last 4 steps' mean loss is below the first 4's
    assert tl[-4:].mean() < tl[:4].mean() - 0.1, tl
