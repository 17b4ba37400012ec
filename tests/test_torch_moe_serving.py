"""MoE serving: the port's ``PayloadLMServer`` on reduced deepseek_moe_16b
(3 layers: dense_first + 2 moe, d=128, 8 routed experts top-2 + 2 shared,
global routing with capacity 1.25, vocab 512) against the JAX package's
``ref`` engine, on the CPU.

Params from ``repro.launch.api.init_params``, carried across with
``params_from_jax``.  The bank is the port's ``calibrate_serving_bank``
(prefill and decode probes), handed to JAX as numpy: both sides serve from
the same frozen stats.  The port runs its ``cuda`` engine (plain versions
on CPU tensors).

Tolerances are wider than the dense model's: a code flip that moves a
router logit across a near tie sends a token to another expert (the
port's routing is the reference's exactly on equal inputs,
tests/test_torch_moe.py), which moves that row's logits by up to 0.55
against a typical 0.2 (mean |logit| ~0.78).  The Pallas engine in
interpret mode is not run here: one 2-request run of 9 tokens takes 25 s
alone, and this file, the formats file and the API file share a 120 s
budget that the formats file's JAX export probe mostly spends.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.core.policy import make_policy as jax_policy
from repro.launch import api
from repro.serving.engine import PayloadLMServer as JaxServer
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import make_policy
from repro_torch.serving import bank as tbank
from repro_torch.serving.engine import PayloadLMServer, Request
from test_torch_serving import _record_logits, _requests, _serve
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

LENGTHS, NEW_TOKENS = (5, 7), 9
NEAR_TIE = 0.2            # top-2 logit margin that a flip may reorder


@pytest.fixture(scope="module")
def moe():
    jcfg = jax_reduced_config("deepseek_moe_16b").replace(remat=False)
    jparams = api.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced_config("deepseek_moe_16b")
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    pol = make_policy("s2fp8")
    calib = np.random.default_rng(11).integers(0, cfg.vocab, (2, 8))
    bank = tbank.calibrate_serving_bank(params, cfg, pol,
                                        torch.as_tensor(calib), passes=2)
    jbank = {k: {d: {f: v.numpy() for f, v in st.items()}
                 for d, st in e.items()} for k, e in bank.items()}
    return {"jcfg": jcfg, "jparams": jparams, "cfg": cfg, "params": params,
            "pol": pol, "bank": bank, "jbank": jbank,
            "ref_pol": jax_policy("s2fp8", backend="ref",
                                  gemm_mode="payload")}


def test_calibration_covers_the_moe_sites(moe):
    """The decode-probing calibration mints the MoE blocks' sites: the
    routed experts' batched GEMMs (``moe/qt*``), the shared experts'
    (``moe/mlp/qt*``), the dense_first MLP, every layer's kv_cache and the
    decode einsums, [L]-stacked per segment."""
    bank = moe["bank"]
    for key in ("seg0:dense_first/mlp/qt0", "seg1:moe/moe/qt0",
                "seg1:moe/moe/qt2", "seg1:moe/moe/mlp/qt2",
                "seg1:moe/kv_cache/t1", "seg1:moe/qt1",
                "seg0:dense_first/qf0"):
        assert key in bank, key
    assert tuple(bank["seg1:moe/moe/qt0"]["b.fwd"]["alpha"].shape) == (2,)
    assert int(bank["seg1:moe/moe/qt0"]["a.fwd"]["last"].min()) == 0


@pytest.fixture(scope="module")
def served(moe):
    """Prompts of 5 and 7 tokens (one prefill bucket), 9 new tokens each,
    2 slots, block 8, the f32_e5m2 pool: the JAX ref engine's run, then
    the port's teacher-forced along its greedy tokens; each side's
    per-step (kind, logits of live rows)."""
    jcfg = moe["jcfg"]
    srv = JaxServer(jcfg, moe["jparams"], moe["ref_pol"], bank=moe["jbank"],
                    slots=2, max_len=96, block=8, cache_fmt="f32_e5m2")
    jsteps = []
    _record_logits(srv, jsteps)
    jtoks = _serve(srv, _requests(JaxRequest, jcfg.vocab, LENGTHS,
                                  NEW_TOKENS))
    srv = PayloadLMServer(moe["cfg"], moe["params"], moe["pol"],
                          bank=moe["bank"], slots=2, max_len=96, block=8,
                          cache_fmt="f32_e5m2")
    steps = []
    _record_logits(srv, steps, [j.reshape(j.shape[0], -1).argmax(-1)
                                for _, j in jsteps])
    toks = _serve(srv, _requests(Request, jcfg.vocab, LENGTHS, NEW_TOKENS))
    assert toks == jtoks and all(len(t) == NEW_TOKENS for t in toks)
    assert [k for k, _ in steps] == [k for k, _ in jsteps]
    return [(k, t.reshape(t.shape[0], -1), j.reshape(j.shape[0], -1))
            for (k, t), (_, j) in zip(steps, jsteps)]


def test_moe_prefill_logits_match_jax_ref_engine(served):
    """The admission's batched prefill (per-row last indices, frozen
    bank) against the JAX ref engine's: max |diff| <= 0.4, mean <= 0.08
    (mean |logit| ~0.78; measured 0.32 / 0.078 with prompts of 5 and
    11)."""
    prefills = [(t, j) for k, t, j in served if k == "prefill"]
    assert prefills
    for t, j in prefills:
        d = np.abs(t - j)
        assert np.isfinite(t).all()
        assert d.max() <= 0.4 and d.mean() <= 0.08, (d.max(), d.mean())


def test_moe_f32_pool_serves_the_jax_ref_engine_tokens(served):
    """The decode steps of the same run: the port, teacher-forced along
    the JAX ref engine's greedy tokens, keeps every step's logits of live
    rows within max |diff| <= 0.75, mean <= 0.15 (measured 0.547 / 0.139
    in a row whose token changed experts; 0.2 / 0.05 typical) and chooses
    JAX's token wherever JAX's top-2 margin exceeds 0.2 (measured over 17
    tokens: 5 of 34 differ, at margins of 0.11 or less)."""
    decodes = [(t, j) for k, t, j in served if k == "decode"]
    assert len(decodes) == NEW_TOKENS - 1
    for i, (t, j) in enumerate(decodes):
        d = np.abs(t - j)
        assert np.isfinite(t).all()
        assert d.max() <= 0.75 and d.mean() <= 0.15, (i, d.max(), d.mean())
        top2 = np.sort(j, axis=-1)[:, -2:]
        for r in range(t.shape[0]):
            if t[r].argmax() != j[r].argmax():
                assert top2[r, 1] - top2[r, 0] <= NEAR_TIE, (i, r, top2[r])


@pytest.mark.parametrize("cache_fmt", ["e5m2", "f32"])
def test_moe_request_keeps_its_tokens_beside_neighbours(moe, cache_fmt):
    """Admission pads a bucket to ``admit_width`` with all-zero token rows,
    and dead slots decode too; under global routing with a capacity those
    rows compete with a request's tokens for expert slots, as in the
    reference.  At this size no token is dropped: a request served beside
    three others (slots 2 and 4) gets the tokens it gets alone."""
    cfg = moe["cfg"]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (5, 11, 7, 9)]

    def serve(ps, slots):
        srv = PayloadLMServer(cfg, moe["params"], moe["pol"],
                              bank=moe["bank"], slots=slots, max_len=64,
                              block=8, cache_fmt=cache_fmt)
        reqs = [Request(prompt=p, max_new_tokens=8) for p in ps]
        return _serve(srv, reqs)

    alone = serve(prompts[:1], 2)[0]
    assert len(alone) == 8 and all(0 <= t < cfg.vocab for t in alone)
    assert serve(prompts, 2)[0] == alone
    assert serve(prompts, 4)[0] == alone
