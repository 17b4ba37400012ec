"""The port's five paged-cache formats, its calibration's train-bank
seeding and its per-tick metrics sink, against the JAX package on the CPU
(the calibrated bank itself is held against the JAX export's algorithm in
``test_torch_serving.py::test_calibrate_matches_jax_export``, whose
module compiles the JAX probe graphs once).

Reduced minicpm_2b (2 layers, d=128, hd=32, vocab 512); params made by
``repro.launch.api.init_params`` and carried across with
``params_from_jax``; one frozen bank made by the port's
``calibrate_serving_bank`` (prefill and decode probes, one pass over two
8-token prompts, the JAX export's own) and handed to JAX as numpy, so both sides serve
from the same stats.  The port runs its ``cuda`` engine, whose wrappers
take the kernels' plain versions on CPU tensors.

The JAX reference here is the ``ref`` engine.  Every f32 pool decodes
through ``blocks.decode_attention`` on both JAX engines and in the port,
so the port's f32_{fmt} pool computes the function of the JAX ``ref``
engine's {fmt} and f32_{fmt} pools (which the JAX package holds token
for token, ``tests/test_serving.py::test_payload_engine_token_exact``).

Tolerances: logits are compared per step by max and mean |difference|
against the bounds stated in each test; they come from payload codes
flipping at RNE boundaries (torch's log2/exp2 differ from XLA's in the
last ulp).  Greedy tokens: this random model's bf16 logits are flat (mean
|logit| ~0.2); at 37 of the 66 greedy choices of the f32_e5m2 run JAX's
top-2 margin is below 0.1, at 3 it is 0, and the flips decide such a
token, after which two runs serve different histories.  So the f32 pools'
decode is held teacher-forced along JAX's tokens: every step's logits
within a bound, and the port's choice JAX's wherever the margin exceeds
``NEAR_TIE``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.core.policy import make_policy as jax_policy
from repro.launch import api
from repro.obs.sinks import MemorySink as JaxMemorySink
from repro.serving.engine import PayloadLMServer as JaxServer
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core import statsbank as tsb
from repro_torch.core.policy import make_policy
from repro_torch.obs.sinks import MemorySink
from repro_torch.serving import bank as tbank
from repro_torch.serving import paged_cache
from repro_torch.serving.engine import PayloadLMServer, Request
from test_torch_serving import _record_logits, _requests, _serve
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

PROMPT_LEN, BATCH, SEED = 8, 2, 0          # the export's probe prompts
LENGTHS = (5, 7)                           # prompts, one prefill bucket
NEW_TOKENS = 33                            # the prefill's + 32 decode steps
NEAR_TIE = 0.1            # top-2 logit margin that a flip may reorder


@pytest.fixture(scope="module")
def sides():
    jcfg = jax_reduced_config("minicpm_2b").replace(n_layers=2, remat=False)
    jparams = api.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced_config("minicpm_2b").replace(n_layers=2)
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    pol = make_policy("s2fp8")
    # export_serving_bank's own probe prompts, drawn as it draws them
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(SEED),
                                         (BATCH, PROMPT_LEN), 0, cfg.vocab),
                      dtype=np.int64)
    bank = tbank.calibrate_serving_bank(params, cfg, pol,
                                        torch.as_tensor(tokens), passes=1)
    jbank = {k: {d: {f: v.numpy() for f, v in st.items()}
                 for d, st in e.items()} for k, e in bank.items()}
    return {"jcfg": jcfg, "jparams": jparams,
            "ref_pol": jax_policy("s2fp8", backend="ref",
                                  gemm_mode="payload"),
            "jbank": jbank, "tokens": tokens, "cfg": cfg, "params": params,
            "bank": bank, "pol": pol}


def test_cache_formats_are_the_reference_five():
    from repro.serving import paged_cache as jpc
    assert paged_cache.CACHE_FMTS == jpc.CACHE_FMTS
    assert paged_cache.PAGED_BLOCK_TYPES == jpc.PAGED_BLOCK_TYPES
    for fmt in jpc.CACHE_FMTS:
        assert paged_cache.base_fmt(fmt) == jpc.base_fmt(fmt)
        assert paged_cache.is_payload(fmt) == jpc.is_payload(fmt)
        assert paged_cache.pool_dtype(fmt).itemsize == \
            np.dtype(jpc.pool_dtype(fmt)).itemsize
    np.testing.assert_array_equal(paged_cache.identity_stats(3).numpy(),
                                  np.asarray(jpc.identity_stats(3)))


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_f32_pool_packs_the_dequantized_payload_pool(sides, fmt):
    """One admission's pack: the f32_{fmt} pool holds dequant of the {fmt}
    pool's payload bit for bit (truncate-apply writes Eq. 5 as
    lut[code]) in every block but the trash block 0, where dummy rows'
    duplicate writes land in no fixed order and nothing reads unmasked."""
    cfg, params = sides["cfg"], sides["params"]
    pools = {}
    for cache_fmt in (fmt, f"f32_{fmt}"):
        srv = PayloadLMServer(cfg, params, sides["pol"], bank=sides["bank"],
                              slots=2, max_len=32, block=8,
                              cache_fmt=cache_fmt)
        for r in _requests(Request, cfg.vocab, (5, 11), 2, 21):
            srv.submit(r)
        assert srv._admit() == 2
        pools[cache_fmt] = srv.caches
    be = sides["pol"].backend_obj
    for seg_p, seg_f in zip(pools[fmt], pools[f"f32_{fmt}"]):
        for pool, ab in (("kp", "kab"), ("vp", "vab")):
            for li in range(seg_p[pool].shape[0]):
                want = paged_cache._decode(seg_p[pool][li, 1:],
                                           seg_p[ab][li], fmt, be)
                assert torch.equal(seg_f[pool][li, 1:], want)
            assert seg_f[pool].abs().sum() > 0


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_f32_pool_serves_the_jax_ref_engine_tokens(sides, fmt):
    """Prompts of 5 and 7 tokens (one prefill bucket), 33 new tokens each
    (32 decode steps), 2 slots, block 8, one bank, the JAX ref engine's
    f32_{fmt} pool, whose greedy tokens are its {fmt} pool's (the JAX
    package holds that token for token over 64 steps,
    ``tests/test_serving.py::test_payload_engine_token_exact``).  The
    port's f32_{fmt} engine, teacher-forced along them, keeps per-step
    logits of live rows (mean |logit| ~0.2) within max |diff| <= 0.15,
    mean <= 0.035 of JAX's at all 34 steps (the prefill bounds of
    ``test_greedy_tokens_and_logits_match_jax_pallas_engine``), and
    chooses JAX's token at each of the 66 choices where JAX's top-2 margin
    exceeds 0.1 (measured: max 0.059 / 0.049 for e5m2 / e4m3, mean at
    most 0.010, and 3 and 4 of the 66 choices differ, all at margins of
    0.039 or less)."""
    jcfg = sides["jcfg"]
    srv = JaxServer(jcfg, sides["jparams"], sides["ref_pol"],
                    bank=sides["jbank"], slots=2, max_len=96, block=8,
                    cache_fmt=f"f32_{fmt}")
    jsteps = []
    _record_logits(srv, jsteps)
    jtoks = _serve(srv, _requests(JaxRequest, jcfg.vocab, LENGTHS,
                                  NEW_TOKENS))
    assert all(len(t) == NEW_TOKENS for t in jtoks)
    jlogits = [j.reshape(j.shape[0], -1) for _, j in jsteps]
    srv = PayloadLMServer(sides["cfg"], sides["params"], sides["pol"],
                          bank=sides["bank"], slots=2, max_len=96, block=8,
                          cache_fmt=f"f32_{fmt}")
    steps = []
    _record_logits(srv, steps, [j.argmax(-1) for j in jlogits])
    assert _serve(srv, _requests(Request, jcfg.vocab, LENGTHS,
                                 NEW_TOKENS)) == jtoks
    assert [k for k, _ in steps] == [k for k, _ in jsteps]
    choices = 0
    for i, ((kind, t), j) in enumerate(zip(steps, jlogits)):
        t = t.reshape(t.shape[0], -1)
        d = np.abs(t - j)
        assert np.isfinite(t).all()
        assert d.max() <= 0.15 and d.mean() <= 0.035, (i, kind, d.max(),
                                                       d.mean())
        top2 = np.sort(j, axis=-1)[:, -2:]
        for r in range(t.shape[0]):
            choices += 1
            if t[r].argmax() != j[r].argmax():
                assert top2[r, 1] - top2[r, 0] <= NEAR_TIE, (i, r, top2[r])
    assert choices == 2 * NEW_TOKENS


@pytest.fixture(scope="module")
def baseline_runs(sides):
    """The fp32 policy on the raw f32 pool without a bank, with a pool too
    small for every context (preemption), on both sides, each with a
    memory sink: (port tokens, port events, JAX tokens, JAX events,
    port preemptions)."""
    kw = dict(bank=None, slots=2, max_len=32, block=8, n_blocks=5,
              cache_fmt="f32")
    jsink, tsink = JaxMemorySink(), MemorySink()
    jsrv = JaxServer(sides["jcfg"], sides["jparams"], jax_policy("fp32"),
                     sink=jsink, **kw)
    tsrv = PayloadLMServer(sides["cfg"], sides["params"], make_policy("fp32"),
                           sink=tsink, **kw)
    vocab = sides["cfg"].vocab
    jt = _serve(jsrv, _requests(JaxRequest, vocab, (9, 9, 9), 20, 5))
    tt = _serve(tsrv, _requests(Request, vocab, (9, 9, 9), 20, 5))
    return tt, tsink.records, jt, jsink.records, tsrv.preemptions


def test_fp32_f32_pool_without_bank_matches_jax(baseline_runs):
    """The fp32 baseline (fp32 policy, raw f32 pool, ``bank=None``,
    identity cache stats): the port's greedy tokens are the JAX engine's,
    through preemption and restart."""
    tt, _, jt, _, preemptions = baseline_runs
    assert preemptions > 0
    assert all(len(t) == 20 for t in tt)
    assert tt == jt


def test_serving_tick_events_match_jax(baseline_runs):
    """Every tick emits the reference's ``serving_tick`` event, with the
    same keys and values tick by tick, preemptions included, and
    ``run_to_completion`` flushes the sink."""
    _, tev, _, jev, _ = baseline_runs
    assert len(tev) == len(jev) > 0
    assert all(e["event"] == "serving_tick" for e in tev)
    assert tev == jev
    assert sum(e["preempted"] for e in tev) == tev[-1]["preemptions_total"] > 0


def test_frozen_f32_decode_runs_no_stats_reductions(sides):
    """A frozen-bank decode tick on the f32_e5m2 pool runs exactly the
    reductions of an unfrozen fp32 tick on the raw f32 pool (the
    reference's ``test_decode_zero_stats_reductions``): no stats
    reduction, and the same reductions along a dimension (softmax)."""
    cfg, params = sides["cfg"], sides["params"]
    counts = []
    for pol, bank, fmt in ((sides["pol"], sides["bank"], "f32_e5m2"),
                           (make_policy("fp32"), None, "f32")):
        srv = PayloadLMServer(cfg, params, pol, bank=bank, slots=2,
                              max_len=32, block=8, cache_fmt=fmt)
        tok = torch.zeros((2, 1), dtype=torch.long)
        pos = torch.zeros((2,), dtype=torch.int32)
        srv._decode(params, tok, srv.caches, pos)       # warm
        with tsb.count_reductions() as c:
            srv._decode(params, tok, srv.caches, pos)
        counts.append((c.n, sum(c.by_op.values())))
    assert counts[0] == counts[1], counts


def test_calibrate_seeds_from_a_train_bank(sides):
    """``train_bank`` seeds every visited site whose entry has the same
    layout before its first refresh (the reference's export seeding): the
    seeded cotangent states stay the train bank's, a seeded cold forward
    state bootstraps as an unseeded one does (so nothing downstream moves),
    a seeded warm one enters the EMA, and a train-bank site the serving
    graphs never visit is not added."""
    cfg, params = sides["cfg"], sides["params"]
    toks = torch.from_numpy(sides["tokens"]).long()

    def calib(seed=None):
        return tbank.calibrate_serving_bank(params, cfg, sides["pol"], toks,
                                            passes=1, train_bank=seed)

    plain = calib()
    key = "seg0:dense/mlp/qt0"
    cold = {d: (tsb.init_site_state(2) if d.endswith("fwd") else
                {f: torch.full_like(v, 7.0) for f, v in st.items()})
            for d, st in plain[key].items()}
    got = calib({key: cold, "not/visited": plain["embed/t0"]})
    assert set(got) == set(plain)
    assert torch.equal(got[key]["a.bwd"]["ema_m"], cold["a.bwd"]["ema_m"])
    for k in plain:
        for d in plain[k]:
            if d.endswith("fwd"):
                for f in plain[k][d]:
                    assert torch.equal(got[k][d][f], plain[k][d][f]), (k, d)
    # a warm seed enters the EMA: two refreshes at decay 0.5 keep a
    # quarter of it (exactly in layer 0, whose input the seed cannot move;
    # layer 1 sees layer 0's MLP output move with it)
    warm = dict(cold, **{"a.fwd": {f: v.clone() for f, v in
                                   plain[key]["a.fwd"].items()}})
    base = calib({key: warm})[key]["a.fwd"]["ema_m"]
    warm["a.fwd"]["ema_m"] += 4.0
    moved = calib({key: warm})[key]["a.fwd"]["ema_m"] - base
    assert abs(moved[0].item() - 1.0) <= 1e-5, moved
    assert torch.allclose(moved, torch.ones_like(moved), atol=0.01), moved
