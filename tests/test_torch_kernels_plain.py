"""Plain versions of the port's kernels against the JAX reference, on the CPU.

Every wrapper takes its kernel's plain version for a CPU tensor, so these
tests run the wrappers themselves and check the launch / plain-call
counts.  Payloads are made on the JAX side and shared bit for bit, so a
difference points at the kernel function, not at quantization.
Tolerances and their reasons:

  * quantize / truncate at shared stats: at most one grid step, in at most
    1e-4 of the elements (last-ulp log2/exp2 differences between torch
    and XLA at RNE boundaries);
  * GEMM without epilogue: |port - ref| <= 1e-5 * (|A| @ |B|) (f32 sums in
    another order); with the epilogue: at most one grid step in at most
    1e-3 of the elements (an f32 rounding difference that lands on a
    boundary of the output grid);
  * payload flash attention: output at most one grid step apart in at most
    1% of the elements (the reference engine's own pallas-vs-ref budget,
    tests/test_qflash.py), lse within 1e-5;
  * paged decode: allclose 2e-5, the reference's own kernel-vs-oracle
    tolerance (tests/test_serving.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.core import qdot as jqdot
from repro.core import s2fp8 as js2
from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro_torch import kernels
from repro_torch.core import s2fp8 as ts2
from repro_torch.kernels import (flash_attention, paged_attention,
                                 s2fp8_matmul, s2fp8_quant)
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

JQ = {"e5m2": jnp.float8_e5m2, "e4m3": jnp.float8_e4m3fn}


def _ordinal(codes_u8: np.ndarray) -> np.ndarray:
    u = codes_u8.astype(np.int32)
    return np.where(u >= 0x80, -(u & 0x7F), u & 0x7F)


def _grid_steps(a: np.ndarray, b: np.ndarray, ab, fmt: str) -> np.ndarray:
    """Grid steps between two arrays of on-grid values (read back through
    the port's quantizer with the site's stats)."""
    def codes(v):
        return ts2.quantize(torch.from_numpy(np.array(v, np.float32)),
                            stats=ab, fmt=fmt).payload.view(torch.uint8).numpy()
    return np.abs(_ordinal(codes(a)) - _ordinal(codes(b)))


def _to_torch_payload(jpayload, fmt: str) -> torch.Tensor:
    u8 = np.asarray(jax.lax.bitcast_convert_type(jpayload, jnp.uint8))
    return torch.from_numpy(u8.copy()).view(ts2.FMT_QDTYPE[fmt])


def _jquant(x: np.ndarray, fmt: str = "e5m2"):
    """JAX-side payload + stats of a numpy array -> (jax tensor, torch
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
@pytest.mark.parametrize("shape", [(257,), (33, 70), (3, 5, 7)])
def test_quant_and_truncate_plain_match_reference(fmt, shape, fresh_counts):
    x = (np.random.default_rng(0).standard_normal(shape) * 0.1
         ).astype(np.float32)
    jt, _, ab = _jquant(x, fmt)
    tp = s2fp8_quant.quant_apply(torch.from_numpy(x), ab, fmt)
    step = np.abs(_ordinal(tp.view(torch.uint8).numpy()) - _ordinal(
        np.asarray(jax.lax.bitcast_convert_type(jt.payload, jnp.uint8))))
    assert step.max() <= 1 and np.mean(step != 0) <= 1e-4

    jtr = jref.s2fp8_truncate_ref(jnp.asarray(x), stats=(jt.alpha, jt.beta),
                                  fmt=fmt)
    ttr = s2fp8_quant.truncate_apply(torch.from_numpy(x), ab, fmt)
    assert ttr.dtype == torch.float32 and ttr.shape == shape
    steps = _grid_steps(np.asarray(jtr), ttr.numpy(), ab, fmt)
    assert steps.max() <= 1 and np.mean(steps != 0) <= 1e-4
    # the wrapper took the plain version and launched nothing
    c = kernels.counts()
    assert c["quant_apply"] == {"launches": 0, "plain_calls": 1}
    assert c["truncate_apply"] == {"launches": 0, "plain_calls": 1}


def test_truncate_keeps_bf16():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (16, 24)).astype(np.float32)).to(torch.bfloat16)
    ab = ts2.compute_stats(x)
    y = s2fp8_quant.truncate_apply(x, ab)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, ts2.truncate_value(x, ab))


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("mkn", [(8, 128, 256), (37, 61, 45), (130, 200, 3)])
def test_gemm_nn_plain_matches_reference(mkn, epilogue, fresh_counts):
    m, k, n = mkn
    rng = np.random.default_rng(2)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    ja, ta, aab = _jquant(a)
    jb, tb, bab = _jquant(b)
    raw = jref.s2fp8_matmul_ref(ja.payload, ja.alpha, ja.beta,
                                jb.payload, jb.alpha, jb.beta)
    out_ab = None
    if epilogue:
        oa, ob = js2.compute_stats_jit(raw)
        out_ab = torch.tensor([float(oa), float(ob)])
        want = np.asarray(jref.s2fp8_matmul_ref(
            ja.payload, ja.alpha, ja.beta, jb.payload, jb.alpha, jb.beta,
            oa, ob))
    else:
        want = np.asarray(raw)
    got = s2fp8_matmul.qmatmul_nn(ta, aab, tb, bab, out_ab).numpy()
    assert got.shape == (m, n)
    if epilogue:
        steps = _grid_steps(want, got, out_ab, "e5m2")
        assert steps.max() <= 1 and np.mean(steps != 0) <= 1e-3
    else:
        scale = np.abs(np.asarray(js2.dequantize(ja))) @ np.abs(
            np.asarray(js2.dequantize(jb)))
        assert np.all(np.abs(got - want) <= 1e-5 * scale + 1e-30)
    assert kernels.counts()["qmatmul_nn"] == {"launches": 0,
                                              "plain_calls": 1}


def test_gemm_rejects_other_layouts_and_bad_shapes():
    from repro_torch.kernels import dispatch
    p = torch.zeros((4, 6), dtype=torch.uint8).view(torch.float8_e5m2)
    ab = torch.tensor([1.0, 0.0])
    with pytest.raises(ValueError):
        dispatch.qmatmul_nd(p, ab, p, ab, layout="tt")
    with pytest.raises(ValueError):
        s2fp8_matmul.qmatmul_nn(p, ab, p, ab)
    with pytest.raises(ValueError):
        s2fp8_matmul.qmatmul_tn(p, ab, p.reshape(6, 4), ab)


@pytest.mark.parametrize("g,hd", [(1, 32), (2, 64), (2, 80), (1, 80)])
def test_qflash_plain_matches_reference_payload_flash(g, hd, fresh_counts):
    b, kvh, sq = 1, 2, 96
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, kvh, g, sq, hd)).astype(np.float32)
    k = rng.standard_normal((b, kvh, sq, hd)).astype(np.float32)
    v = rng.standard_normal((b, kvh, sq, hd)).astype(np.float32)
    (jq, tq, qab), (jk, tk, kab), (jv, tv, vab) = (_jquant(t) for t in
                                                   (q, k, v))
    be = jbackend.get_backend("ref")
    raw, _ = jqdot._payload_flash_fwd(be, jq, jk, jv, True, None, "e5m2",
                                      512, 512, None)
    oa, ob = js2.compute_stats_jit(raw)
    want, want_lse = jqdot._payload_flash_fwd(be, jq, jk, jv, True, None,
                                              "e5m2", 512, 512, (oa, ob))
    out_ab = torch.tensor([float(oa), float(ob)])
    got, lse = flash_attention.qflash_fwd(
        tq.reshape(b * kvh * g, sq, hd), tk.reshape(b * kvh, sq, hd),
        tv.reshape(b * kvh, sq, hd), qab, kab, vab, g=g, out_ab=out_ab)
    steps = _grid_steps(np.asarray(want).reshape(-1),
                        got.numpy().reshape(-1), out_ab, "e5m2")
    assert steps.max() <= 1 and np.mean(steps != 0) < 0.01
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want_lse).reshape(b * kvh * g, sq),
                               atol=1e-5, rtol=1e-5)
    assert kernels.counts()["qflash_fwd"] == {"launches": 0,
                                              "plain_calls": 1}


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_paged_plain_matches_reference(fmt, fresh_counts):
    """tests/test_serving.py's paged fixture: 4 slots, 2 KV heads x 3
    queries, block 16, 4 blocks per slot, a dead slot and shared blocks."""
    b, kvh, g, hd, blk, max_b, nb = 4, 2, 3, 64, 16, 4, 9
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, kvh, g, hd)).astype(np.float32)
    kf = rng.standard_normal((nb, kvh, blk, hd)).astype(np.float32)
    vf = rng.standard_normal((nb, kvh, blk, hd)).astype(np.float32)
    ka, kb_, va, vb_ = 4.0, 1.5, 3.0, -0.5
    kp = js2.quantize(jnp.asarray(kf), stats=(ka, kb_), fmt=fmt).payload
    vp = js2.quantize(jnp.asarray(vf), stats=(va, vb_), fmt=fmt).payload
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0],
                      [7, 8, 1, 2]], np.int32)
    positions = np.array([5, 33, 0, 60], np.int32)
    want = jpa.paged_decode_reference(jnp.asarray(q), kp, vp, ka, kb_, va,
                                      vb_, jnp.asarray(table),
                                      jnp.asarray(positions))
    got = paged_attention.paged_decode_attention(
        torch.from_numpy(q), _to_torch_payload(kp, fmt),
        _to_torch_payload(vp, fmt), torch.tensor([ka, kb_]),
        torch.tensor([va, vb_]), torch.from_numpy(table),
        torch.from_numpy(positions), fmt=fmt)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert kernels.counts()["paged_decode"] == {"launches": 0,
                                                "plain_calls": 1}


def test_wrappers_check_shapes():
    q = torch.zeros((2, 1, 1, 8))
    pool = torch.zeros((3, 1, 4, 8), dtype=torch.uint8).view(torch.float8_e5m2)
    ab = torch.tensor([1.0, 0.0])
    with pytest.raises(ValueError):
        paged_attention.paged_decode_attention(
            q, pool, pool, ab, ab, torch.zeros((3, 2), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32))
    p3 = torch.zeros((4, 5, 8), dtype=torch.uint8).view(torch.float8_e5m2)
    with pytest.raises(ValueError):
        flash_attention.qflash_fwd(p3, p3[:3], p3[:3], ab, ab, ab, g=1)
