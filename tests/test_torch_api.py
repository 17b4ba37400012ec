"""The port's launcher API (``repro_torch.launch.api``) against the JAX
package's ``repro.launch.api``, on the CPU, and the launchers that go
through it.

Reduced minicpm_2b (2 layers) and reduced whisper_medium (the audio stub:
frame embeddings into the encoder), fp32 policy and f32 activations on
both sides, so the comparison is of the step functions' wiring (which
loss, which prefill, which decode, which optimizer and schedule), not of
S2FP8 or bf16 rounding.  The JAX
params are carried across with ``params_from_jax``; batches are seeded
numpy.  Tolerances: logits and losses within 2e-4 absolute (f32 sums in
another order), updated params within 1e-5: one AdamW step at lr 5e-5
moves a weight by about 5e-5 whatever its gradient, so near-zero
gradients whose f32 noise differs move by different fractions of it
(measured 2.7e-6).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.core.policy import make_policy as jax_policy
from repro.launch import api as japi
from repro.models import transformer as jtlm
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import make_policy
from repro_torch.launch import api
from repro_torch.models import transformer as tlm
from repro_torch.optim.optimizers import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

B, S = 2, 12
TOL = 2e-4


def _cfgs(arch):
    jcfg = jax_reduced_config(arch).replace(remat=False,
                                            activation_dtype="float32")
    cfg = get_reduced_config(arch).replace(remat=False,
                                           activation_dtype="float32")
    if arch == "minicpm_2b":
        jcfg, cfg = jcfg.replace(n_layers=2), cfg.replace(n_layers=2)
    return jcfg, cfg


def _batch(cfg, rng):
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    if cfg.enc_dec:
        frames = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        return {"enc_inputs": frames, "dec_tokens": toks[:, :-1],
                "dec_labels": toks[:, 1:]}
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(b):
    return {k: torch.from_numpy(v) if v.dtype == np.float32
            else torch.from_numpy(v).long() for k, v in b.items()}


def _close(t, j, tol=TOL):
    t = t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    d = np.abs(t - np.asarray(jnp.asarray(j, jnp.float32)))
    assert d.max() <= tol, d.max()


@pytest.mark.parametrize("arch", ["minicpm_2b", "whisper_medium"])
def test_init_params_has_the_reference_tree(arch):
    """``api.init_params`` dispatches as the reference's: the same leaves
    in the same order and shapes (values differ: another generator), on
    the device asked for, from ``seed``."""
    jcfg, cfg = _cfgs(arch)
    want = jax.eval_shape(lambda k: japi.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    got = api.init_params(cfg, seed=3, device="cpu")
    gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert [tuple(t.shape) for t in gl] == [w.shape for w in wl]
    assert all(t.device.type == "cpu" for t in gl)
    again = api.init_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(gl, tree_leaves(again)))


@pytest.mark.parametrize("arch", ["minicpm_2b", "whisper_medium"])
def test_steps_match_the_jax_api(arch):
    """``make_loss_fn``, ``make_prefill_step``, ``make_decode_step`` (two
    greedy tokens) and one ``make_train_step`` step (at step 50 of the
    100-step warmup) on the same params and batch: the loss, the logits,
    the train step's loss, grad norm and lr, and the updated params."""
    jcfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(7)
    batch = _batch(cfg, rng)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    jpol, pol = jax_policy("fp32"), make_policy("fp32")
    tb = _torch_batch(batch)

    jloss, _ = jax.jit(lambda p, b: japi.make_loss_fn(jcfg)(p, b, jpol))(
        jparams, batch)
    with torch.no_grad():
        loss, _ = api.make_loss_fn(cfg)(params, tb, pol)
    _close(loss, jloss)

    jpre, jdec = (japi.make_prefill_step(jcfg, jpol),
                  japi.make_decode_step(jcfg, jpol))
    pre, dec = api.make_prefill_step(cfg, pol), api.make_decode_step(cfg, pol)
    bos = np.ones((B, 1), np.int32)
    with torch.no_grad():
        if cfg.enc_dec:
            jl, jstate = jax.jit(jpre)(jparams, {"enc_inputs":
                                                 batch["enc_inputs"],
                                                 "dec_bos": bos})
            tl, state = pre(params, {"enc_inputs": tb["enc_inputs"],
                                     "dec_bos": torch.from_numpy(bos).long()})
            assert state["caches"]["k"].shape[3] == api.WHISPER_DEC_LEN
            index = 1
        else:
            jl, jstate = jax.jit(jpre)(
                jparams, {"tokens": batch["tokens"]},
                jtlm.init_caches(jcfg, B, S + 4, dtype=jnp.float32))
            tl, state = pre(params, {"tokens": tb["tokens"]},
                            tlm.init_caches(cfg, B, S + 4, device="cpu"))
            index = S
        _close(tl, jl)
        jdec_j = jax.jit(jdec)
        for _ in range(2):
            tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(
                np.int32)
            jl, jstate = jdec_j(jparams, {"token": tok}, jstate, index)
            tl, state = dec(params, {"token": torch.from_numpy(tok).long()},
                            state, index)
            _close(tl, jl)
            index += 1

    jstep, jopt = japi.make_train_step(jcfg, jpol, lr=1e-4)
    jp2, _, jm = jax.jit(jstep)(jparams, jopt.init(jparams), batch,
                                jnp.int32(50))
    step, opt = api.make_train_step(cfg, pol, lr=1e-4)
    p2, _, m = step(params, opt.init(params), tb, 50)
    for k in ("loss", "grad_norm", "lr"):
        assert abs(float(m[k]) - float(jm[k])) <= TOL * max(
            1.0, abs(float(jm[k]))), (k, float(m[k]), float(jm[k]))
    for t, j in zip(tree_leaves(p2), jax.tree_util.tree_leaves(jp2)):
        _close(t.detach(), j, 1e-5)


def test_serve_launcher_metrics_sink(tmp_path, capsys):
    """``--metrics jsonl:<path>``: one ``serving_tick`` event a tick, as
    many as the launcher's tick count, and params through
    ``api.init_params``."""
    from repro_torch.launch import serve
    path = tmp_path / "ticks.jsonl"
    serve.main(["--arch", "minicpm_2b", "--reduced", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--max-len", "32",
                "--prompt-len", "6", "--new-tokens", "3", "--calib-passes",
                "1", "--cache-fmt", "f32_e4m3", "--metrics", f"jsonl:{path}"])
    out = capsys.readouterr().out
    ticks = int(out.split(" ticks,")[0].rsplit(" ", 1)[-1])
    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(events) == ticks > 0
    assert all(e["event"] == "serving_tick" for e in events)
    assert [e["tick"] for e in events] == list(range(1, ticks + 1))
    assert sum(e["decode_tokens"] + e["admitted"] for e in events) == 9


def test_serve_launcher_serves_the_moe(capsys, monkeypatch):
    """``--arch deepseek_moe_16b --reduced`` serves through the paged engine
    from a calibrated bank; the launcher makes its params through
    ``api.init_params``."""
    from repro_torch.launch import serve
    calls = []
    init = api.init_params
    monkeypatch.setattr(api, "init_params",
                        lambda *a, **k: calls.append(a) or init(*a, **k))
    serve.main(["--arch", "deepseek_moe_16b", "--reduced", "--device",
                "cpu", "--requests", "2", "--slots", "2", "--max-len", "32",
                "--prompt-len", "6", "--new-tokens", "3", "--calib-passes",
                "1"])
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out and "deepseek-moe-16b" in out
    assert len(calls) == 1


def test_train_launcher_goes_through_the_api(monkeypatch, capsys):
    """The train launcher's params come from ``api.init_params`` and its
    loss from ``api.make_loss_fn``, whose enc-dec batch carries the
    reference's ``enc_inputs``."""
    from repro_torch.launch import train
    seen = []
    make = api.make_loss_fn

    def spy(cfg):
        loss = make(cfg)

        def wrapped(params, batch, pol):
            seen.append(sorted(batch))
            return loss(params, batch, pol)
        return wrapped
    monkeypatch.setattr(api, "make_loss_fn", spy)
    train.main(["--arch", "transformer_tiny", "--reduced", "--device", "cpu",
                "--steps", "1", "--batch", "2", "--seq", "8"])
    assert seen and seen[0] == ["dec_labels", "dec_tokens", "enc_inputs"]
    assert "loss" in capsys.readouterr().out
