"""Plain versions of the training slice's kernels against the JAX package,
on the CPU.

Every wrapper takes its kernel's plain version for a CPU tensor, so these
tests run the wrappers themselves and check the launch / plain-call
counts.  Payloads are made on the JAX side and shared bit for bit, so a
difference points at the kernel function, not at quantization.  The JAX
side runs the Pallas kernels in interpret mode, as the JAX package's own
tests do on the CPU.  Tolerances and their reasons:

  * dequantize: within 1e-6 relative (the same Eq. 4 map; torch's and
    XLA's log2/exp2 differ in the last ulp);
  * NT / TN GEMM without epilogue: |port - ref| <= 1e-5 * max|C| — an
    absolute bound scaled by the output's size, because f32 sums in
    another order lose relative precision on outputs that cancel to
    near zero; with the epilogue: codes at most one grid step apart in at
    most 1e-3 of the outputs;
  * flash backward: dq, dk, dv within 1e-5 * max|ref| (f32 sums over
    other chunkings of the keys and queries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import s2fp8 as js2
from repro.kernels import dispatch as jdispatch
from repro.kernels import flash_attention as jflash
from repro.kernels import ref as jref
from repro.kernels.s2fp8_matmul import s2fp8_matmul_pallas
from repro.kernels.s2fp8_quant import dequant_pallas
from repro_torch import kernels
from repro_torch.core import s2fp8 as ts2
from repro_torch.kernels import (dispatch, flash_attention, s2fp8_matmul,
                                 s2fp8_quant)
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")


def _ordinal(codes_u8: np.ndarray) -> np.ndarray:
    u = codes_u8.astype(np.int32)
    return np.where(u >= 0x80, -(u & 0x7F), u & 0x7F)


def _grid_steps(a: np.ndarray, b: np.ndarray, ab, fmt: str = "e5m2"
                ) -> np.ndarray:
    """Grid steps between two arrays of on-grid values (read back through
    the port's quantizer with the site's stats)."""
    def codes(v):
        return ts2.quantize(torch.from_numpy(np.array(v, np.float32)),
                            stats=ab, fmt=fmt).payload.view(torch.uint8).numpy()
    return np.abs(_ordinal(codes(a)) - _ordinal(codes(b)))


def _to_torch_payload(jpayload, fmt: str = "e5m2") -> torch.Tensor:
    u8 = np.asarray(jax.lax.bitcast_convert_type(jpayload, jnp.uint8))
    return torch.from_numpy(u8.copy()).view(ts2.FMT_QDTYPE[fmt])


def _jquant(x: np.ndarray, fmt: str = "e5m2"):
    """JAX-side payload + stats of a numpy array -> (jax S2FP8Tensor, torch
    payload, torch [2] stats)."""
    a, b = js2.compute_stats_jit(jnp.asarray(x),
                                 target_max=js2.FMT_TARGET_MAX[fmt])
    t = js2.quantize(jnp.asarray(x), stats=(a, b), fmt=fmt)
    return t, _to_torch_payload(t.payload, fmt), torch.tensor(
        [float(a), float(b)], dtype=torch.float32)


@pytest.fixture
def fresh_counts():
    kernels.reset_counts()
    yield
    kernels.reset_counts()


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
@pytest.mark.parametrize("shape", [(256, 512), (33, 70), (3, 5, 7)])
def test_dequant_plain_matches_dequant_pallas(fmt, shape, fresh_counts):
    x = (np.random.default_rng(0).standard_normal(shape) * 0.1
         ).astype(np.float32)
    jt, tp, ab = _jquant(x, fmt)
    if len(shape) == 2 and shape[0] % 256 == 0:
        want = dequant_pallas(jt.payload, jt.alpha, jt.beta, interpret=True)
    else:
        want = jdispatch.dequant_nd(jt.payload, jt.alpha, jt.beta,
                                    interpret=True)
    got = dispatch.dequant_nd(tp, ab)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    assert kernels.counts()["dequant"] == {"launches": 0, "plain_calls": 1}


@pytest.mark.parametrize("case", ["nan", "nan_and_zeros", "all_nan",
                                  "all_zero", "inf"])
def test_stats_partials_match_jax_on_degenerate_inputs(case):
    """NaNs are left out of the stats like zeros (NaN > 0 is false), an
    all-zero or all-NaN tensor gets the identity transform, and an inf
    wins the max, as in the reference.  Tolerance: 1e-5 relative for the
    sum (summation order), 1e-6 for the max and the stats."""
    x = (np.random.default_rng(1).standard_normal((64, 48)) * 0.1
         ).astype(np.float32)
    if case == "nan":
        x[3, 7] = x[40, 1] = np.nan
    elif case == "nan_and_zeros":
        x[::5] = 0.0
        x[2, :9] = np.nan
    elif case == "all_nan":
        x[:] = np.nan
    elif case == "all_zero":
        x[:] = 0.0
    else:
        x[10, 10] = np.inf
    want = [float(v) for v in js2.compute_stats_partials(jnp.asarray(x))]
    got = [float(v) for v in ts2.compute_stats_partials(torch.from_numpy(x))]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-6)
    if case != "inf":
        assert np.isfinite(want[0]) and np.isfinite(got[0])
        ja, jb = js2.compute_stats_jit(jnp.asarray(x))
        ta, tb = ts2.compute_stats(torch.from_numpy(x)).tolist()
        assert np.isfinite([ta, tb]).all()
        np.testing.assert_allclose([ta, tb], [float(ja), float(jb)],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("layout,mkn", [
    ("nt", (128, 256, 64)), ("tn", (128, 256, 64)),     # Pallas blocks
    ("nt", (130, 70, 40)), ("tn", (130, 70, 33)),       # ragged: padded
])
def test_gemm_nt_tn_plain_matches_reference(layout, mkn, epilogue,
                                            fresh_counts):
    m, k, n = mkn
    rng = np.random.default_rng(2)
    a = rng.standard_normal((m, k) if layout == "nt" else (k, m)
                            ).astype(np.float32)
    b = (rng.standard_normal((n, k) if layout == "nt" else (k, n))
         / np.sqrt(k)).astype(np.float32)
    (ja, ta, aab), (jb, tb, bab) = _jquant(a), _jquant(b)
    raw = jref.s2fp8_matmul_ref(ja.payload, ja.alpha, ja.beta, jb.payload,
                                jb.alpha, jb.beta, layout=layout)
    out_ab = None
    if epilogue:
        oa, ob = js2.compute_stats_jit(raw)
        out_ab = torch.tensor([float(oa), float(ob)])
    ostats = None if out_ab is None else (oa, ob)
    wants = [np.asarray(jref.s2fp8_matmul_ref(
        ja.payload, ja.alpha, ja.beta, jb.payload, jb.alpha, jb.beta,
        *(ostats or (None, None)), layout=layout))]
    if m % 128 == 0:
        wants.append(np.asarray(s2fp8_matmul_pallas(
            ja.payload, ja.alpha, ja.beta, jb.payload, jb.alpha, jb.beta,
            *(ostats or (None, None)), layout=layout, interpret=True)))
    else:
        wants.append(np.asarray(jdispatch.qmatmul_nd(
            ja.payload, ja.alpha, ja.beta, jb.payload, jb.alpha, jb.beta,
            layout=layout, epilogue_stats=ostats, interpret=True)))
    got = dispatch.qmatmul_nd(ta, aab, tb, bab, layout=layout,
                              epilogue_stats=out_ab).numpy()
    assert got.shape == (m, n)
    for want in wants:
        if epilogue:
            steps = _grid_steps(want, got, out_ab)
            assert steps.max() <= 1 and np.mean(steps != 0) <= 1e-3
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
    assert kernels.counts()[f"qmatmul_{layout}"] == {"launches": 0,
                                                     "plain_calls": 1}


def _flash_residuals(b, kvh, g, s, d, causal, window, seed=3):
    """Shared payload residuals of one attention call, made on the JAX
    side: q/k/v, the quantized output cotangent, lse of the forward and
    delta = rowsum(deq(g) * deq(o))."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kvh, g, s, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    dout = (rng.standard_normal((b, kvh, g, s, d)) * 1e-2).astype(np.float32)
    parts = [_jquant(t) for t in (q, k, v, dout)]
    jq, jk, jv, jg = (p[0] for p in parts)
    out, lse = jflash.flash_fwd_reference(
        js2.dequantize(jq), js2.dequantize(jk), js2.dequantize(jv),
        causal=causal, window=window)
    jo = _jquant(np.asarray(out))[0]
    delta = jnp.sum(js2.dequantize(jg) * js2.dequantize(jo), axis=-1,
                    keepdims=True)
    return parts, lse, delta


@pytest.mark.parametrize("causal,window,g", [(True, None, 1), (True, 48, 2),
                                             (False, None, 2)])
def test_qflash_bwd_plain_matches_pallas_and_reference(causal, window, g,
                                                       fresh_counts):
    b, kvh, s, d = 1, 2, 128, 32
    parts, lse, delta = _flash_residuals(b, kvh, g, s, d, causal, window)
    (jq, tq, qab), (jk, tk, kab), (jv, tv, vab), (jg, tg, gab) = parts
    bh = b * kvh * g

    def heads(p):
        return p.reshape(-1, s, d)

    # the kernels' function: per-head dk / dv, against the Pallas kernels
    want = jflash.qflash_bwd_pallas(
        heads(jq.payload), heads(jk.payload), heads(jv.payload),
        heads(jg.payload), (jq.alpha, jq.beta), (jk.alpha, jk.beta),
        (jv.alpha, jv.beta), (jg.alpha, jg.beta), lse.reshape(bh, s),
        delta.reshape(bh, s), g=g, causal=causal, window=window, bq=64,
        bk=64, interpret=True)
    got = flash_attention.qflash_bwd(
        heads(tq), heads(tk), heads(tv), heads(tg), qab, kab, vab, gab,
        torch.from_numpy(np.array(lse).reshape(bh, s)),
        torch.from_numpy(np.array(delta).reshape(bh, s)), g=g,
        causal=causal, window=window)
    for x, y in zip(got, want):
        y = np.asarray(y)
        assert x.shape == y.shape
        np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                   atol=1e-5 * np.abs(y).max())
    assert kernels.counts()["qflash_bwd"] == {"launches": 0,
                                              "plain_calls": 1}

    # the grouped layout with the group sum, against the reference's
    # recompute backward
    ref = jflash.flash_bwd_reference(
        js2.dequantize(jq), js2.dequantize(jk), js2.dequantize(jv),
        js2.dequantize(jg), lse, delta, causal=causal, window=window,
        q_chunk=64, kv_chunk=64)
    ts = [ts2.S2FP8Tensor(p, ab) for p, ab in ((tq, qab), (tk, kab),
                                               (tv, vab), (tg, gab))]
    grouped = dispatch.qflash_bwd_grouped(
        *ts, torch.from_numpy(np.array(lse)),
        torch.from_numpy(np.array(delta)), causal=causal, window=window,
        scale=1.0 / np.sqrt(d))
    for x, y in zip(grouped, ref):
        y = np.asarray(y)
        assert x.shape == y.shape
        np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                   atol=1e-5 * np.abs(y).max())


def test_flash_bwd_reference_matches_jax_reference():
    """The port of ``flash_bwd_reference`` itself, on f32 inputs, with a
    ragged chunking (96 rows in chunks of 32) and GQA."""
    rng = np.random.default_rng(4)
    b, kvh, g, s, d = 1, 2, 2, 96, 16
    q, dout = (rng.standard_normal((b, kvh, g, s, d)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((b, kvh, s, d)).astype(np.float32)
            for _ in range(2))
    out, lse = jflash.flash_fwd_reference(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), window=40)
    delta = jnp.sum(jnp.asarray(dout) * out, axis=-1, keepdims=True)
    want = jflash.flash_bwd_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(dout),
        lse, delta, window=40, q_chunk=32, kv_chunk=32)
    got = flash_attention.flash_bwd_reference(
        *(torch.from_numpy(t) for t in (q, k, v, dout)),
        torch.from_numpy(np.array(lse)), torch.from_numpy(np.array(delta)),
        window=40, q_chunk=32, kv_chunk=32)
    for x, y in zip(got, want):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                   atol=1e-5 * np.abs(y).max())


def test_train_wrappers_check_shapes():
    p = torch.zeros((4, 8, 16), dtype=torch.uint8).view(torch.float8_e5m2)
    ab = torch.tensor([1.0, 0.0])
    lse = torch.zeros(4, 8)
    with pytest.raises(ValueError):            # cotangent of another shape
        flash_attention.qflash_bwd(p, p[:2], p[:2], p[:, :4], ab, ab, ab, ab,
                                   lse, lse, g=2)
    with pytest.raises(ValueError):            # lse of another shape
        flash_attention.qflash_bwd(p, p[:2], p[:2], p, ab, ab, ab, ab,
                                   lse[:, :4], lse, g=2)
    with pytest.raises(ValueError):            # nt: K mismatch
        s2fp8_matmul.qmatmul_nt(p[0], ab, p[0, :, :8], ab)
    with pytest.raises(ValueError):            # 3-D payloads
        s2fp8_matmul.qmatmul_tn(p, ab, p, ab)
