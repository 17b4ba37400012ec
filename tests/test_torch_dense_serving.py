"""The port's dense-cache ``LMServer`` against the JAX ``LMServer``, on the
CPU.

Reduced falcon_mamba_7b (4 mamba1 layers, d 128, di 256, 8 states, vocab
512); params made by ``repro.launch.api.init_params`` and carried across
with ``params_from_jax``.  Five requests with prompts of 5, 8, 3, 11 and 6
tokens share 3 slots, so admissions happen while other slots decode, and
four of the prompts are right-padded to their power-of-two bucket.  The
JAX side runs the ``ref`` engine with payload GEMMs (or fp32); the port
its ``cuda_fused`` engine with payload GEMMs, whose wrappers take the
kernels' plain versions on CPU tensors.  Both serve with exact per-call
stats (no bank).  Tolerances are stated beside each comparison.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.core.policy import make_policy as jax_policy
from repro.launch import api
from repro.serving.engine import LMServer as JaxLMServer
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import make_policy
from repro_torch.models import transformer as tlm
from repro_torch.serving.engine import LMServer, PayloadLMServer, Request
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

ARCH = "falcon_mamba_7b"
LENGTHS, NEW_TOKENS, SLOTS, MAX_LEN = (5, 8, 3, 11, 6), (6, 4, 6, 3, 5), 3, 32


def _serve(server, request_cls, prompts):
    """Serve ``prompts`` to completion.  Returns each request's tokens and,
    per prefill or decode call, (last-position logits [slots, V] as f32
    numpy, [(row, request index, tokens the request had emitted)])."""
    reqs = [request_cls(prompt=p, max_new_tokens=n)
            for p, n in zip(prompts, NEW_TOKENS)]
    steps = []
    prefill, decode = server._prefill, server._decode

    def logits_np(out):
        lg = out[0][:, -1]
        return (lg.float().numpy() if isinstance(lg, torch.Tensor)
                else np.asarray(lg, np.float32))

    def p(*args):
        toks = np.asarray(args[1])
        rows = []
        for r, row in enumerate(toks):
            for i, pr in enumerate(prompts):
                if (np.array_equal(row[:len(pr)], pr)
                        and not row[len(pr):].any()):
                    rows.append((r, i, 0))
        out = prefill(*args)
        steps.append((logits_np(out), rows))
        return out

    def d(*args):
        rows = [(s, next(i for i, q in enumerate(reqs) if q is r), len(r.out))
                for s, r in enumerate(server.slot_req) if r is not None]
        out = decode(*args)
        steps.append((logits_np(out), rows))
        return out

    server._prefill, server._decode = p, d
    for r in reqs:
        server.submit(r)
    server.run_to_completion()
    return [r.out for r in reqs], steps


@pytest.fixture(scope="module")
def runs():
    cfg_j, cfg = jax_reduced_config(ARCH), get_reduced_config(ARCH)
    params_j = api.init_params(cfg_j, jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(params_j), device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, n, dtype=np.int32) for n in LENGTHS]
    out = {"cfg": cfg, "params": params, "prompts": prompts}
    for mode in ("fp32", "s2fp8"):
        jp = (jax_policy("fp32") if mode == "fp32" else
              jax_policy(mode, backend="ref", gemm_mode="payload"))
        tp = make_policy(mode, "cuda_fused", "payload")
        out[mode] = {
            "jax": _serve(JaxLMServer(cfg_j, params_j, jp, slots=SLOTS,
                                      max_len=MAX_LEN), JaxRequest, prompts),
            "port": _serve(LMServer(cfg, params, tp, slots=SLOTS,
                                    max_len=MAX_LEN), Request, prompts)}
    return out


def test_fp32_tokens_and_logits_match_jax(runs):
    """fp32: the same greedy tokens for every request, and at every
    prefill and decode call logits within max |diff| <= 0.05 and mean <=
    0.01: the scan's f32 sums run in another order, which now and then
    moves a bf16 rounding of a hidden state by one ulp (measured: max
    0.0176, mean 0.0041, most calls the same bits)."""
    (tj, sj), (tt, st) = runs["fp32"]["jax"], runs["fp32"]["port"]
    assert tt == tj
    assert [len(t) for t in tt] == list(NEW_TOKENS)
    assert len(st) == len(sj) and [r for _, r in st] == [r for _, r in sj]
    for (lj, rows), (lt, _) in zip(sj, st):
        idx = [r for r, _, _ in rows]
        d = np.abs(lt[idx] - lj[idx])
        assert d.max() <= 0.05 and d.mean() <= 0.01, (d.max(), d.mean())


def test_s2fp8_logits_within_budget(runs):
    """s2fp8 with exact per-call stats and payload GEMMs: at every call,
    the logits of the rows whose prompt and tokens so far agree on both
    sides stay within max |diff| <= 0.6 and mean <= 0.15, and every row's
    logits are finite.  The two sides' stats differ in their last bits
    (XLA's log2 is log * 1/ln2, the reductions sum in another order, the
    port's fused-stats engine in f64), so GEMM outputs move by an f32 ulp
    and some cross a bf16 rounding boundary, and the SSM state carries the
    moves from step to step: through four recurrent layers this gave max
    0.18, mean 0.036 on the prefill logits and up to max 0.31, mean 0.078
    by the last decode step (the minicpm serving slice's budget is 0.045 /
    0.009 for two attention layers at prefill).  Tokens may part after
    such a move, so only agreeing rows compare."""
    (tj, sj), (tt, st) = runs["s2fp8"]["jax"], runs["s2fp8"]["port"]
    compared = 0
    for (lj, rows_j), (lt, rows_t) in zip(sj, st):
        assert np.isfinite(lt[[r for r, _, _ in rows_t]]).all()
        agree = [r for r, i, n in rows_t if (r, i, n) in rows_j
                 and tt[i][:n] == tj[i][:n]]
        if not agree:
            continue
        d = np.abs(lt[agree] - lj[agree])
        assert d.max() <= 0.6 and d.mean() <= 0.15, (d.max(), d.mean())
        compared += len(agree)
    # every prefill row and most decode rows are compared
    assert compared >= len(LENGTHS) + 10
    assert [t[0] for t in tt] == [t[0] for t in tj]


def _greedy(params, cfg, prompt, n_new):
    """Unpadded greedy decoding of one prompt: prefill of exactly its
    tokens, then ``n_new - 1`` decode steps."""
    pol = make_policy("fp32")
    caches = tlm.init_caches(cfg, 1, MAX_LEN)
    with torch.no_grad():
        logits, caches = tlm.prefill(params, torch.from_numpy(
            prompt[None]).long(), cfg, pol, caches)
        out = [int(logits[0, -1].argmax())]
        for t in range(n_new - 1):
            logits, caches = tlm.decode_step(
                params, torch.tensor([[out[-1]]]), cfg, pol, caches,
                torch.tensor([len(prompt) + t]))
            out.append(int(logits[0, -1].argmax()))
    return out


def test_padding_reaches_the_mamba_state_as_in_the_reference(runs):
    """The reference's fault, kept by the port: LMServer right-pads a
    prompt to its power-of-two bucket and the mamba1 scan and conv window
    run on through the pads, so a padded prompt's tokens after the first
    are those of the JAX server, not those of unpadded greedy decoding.
    The first token is read at the true last index and agrees; an 8-token
    prompt (bucket 8, no pads) decodes exactly as without the server."""
    cfg, params, prompts = runs["cfg"], runs["params"], runs["prompts"]
    (tj, _), (tt, _) = runs["fp32"]["jax"], runs["fp32"]["port"]
    padded, whole = LENGTHS.index(5), LENGTHS.index(8)
    alone = _greedy(params, cfg, prompts[padded], NEW_TOKENS[padded])
    assert tt[padded] == tj[padded]
    assert tt[padded][0] == alone[0]
    assert tt[padded][1:] != alone[1:]
    assert tt[whole] == _greedy(params, cfg, prompts[whole],
                                NEW_TOKENS[whole])


def test_attention_blocks_are_refused_in_dense_decode():
    """The dense-cache decode of attention blocks (the reference's
    decode_attention) runs: one reduced minicpm layer served by LMServer
    decodes every request with the JAX LMServer's greedy tokens (fp32,
    the same params).  The paged engine refuses mamba1 blocks, as the
    reference's does."""
    cfg_j = jax_reduced_config("minicpm_2b").replace(n_layers=1)
    cfg = get_reduced_config("minicpm_2b").replace(n_layers=1)
    params_j = api.init_params(cfg_j, jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(params_j), device="cpu")
    outs = []
    for server, req_cls in (
            (LMServer(cfg, params, make_policy("fp32"), slots=2,
                      max_len=16), Request),
            (JaxLMServer(cfg_j, params_j, jax_policy("fp32"), slots=2,
                         max_len=16), JaxRequest)):
        req = req_cls(prompt=np.arange(1, 6, dtype=np.int32),
                      max_new_tokens=3)
        server.submit(req)
        server.run_to_completion()
        outs.append(req.out)
    assert len(outs[0]) == 3 and outs[0] == outs[1]
    mcfg = get_reduced_config(ARCH).replace(n_layers=1, pattern=("mamba1",))
    mparams = tlm.init_lm(mcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="global-attention"):
        PayloadLMServer(mcfg, mparams, make_policy("s2fp8"), bank={},
                        slots=2, max_len=16, block=8)


def test_dense_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--reduced", "--engine", "dense",
                "--device", "cpu", "--requests", "3", "--slots", "2",
                "--prompt-len", "6", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "engine dense, policy s2fp8, numerics cuda_fused" in out
    assert "[serve] 3 requests, 9 tokens" in out
