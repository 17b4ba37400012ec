"""The port's S2FP8 format (repro_torch.core.s2fp8) against the JAX
reference (repro.core.s2fp8), on the CPU.

Inputs come from numpy with a seed and go through both frameworks.
Tolerances and their reasons:

  * degenerate stats cases, fp8 casts: bit for bit (pure IEEE arithmetic
    and RNE casts, identical in both frameworks);
  * (alpha, beta) from the port's own reduction: within 1e-5 relative
    (the f32 sum of log2|x| runs in another order);
  * payload codes at shared (alpha, beta): at most one grid step apart in
    at most 1e-4 of the elements — torch's log2/exp2 differ from XLA's in
    the last ulp, which moves values sitting on an RNE boundary;
  * ``dequantize(quantize(x, s)) == truncate_value(x, s)``: bit for bit
    within torch (the identity the payload GEMMs and the KV pool rely on).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import s2fp8 as js2
from repro_torch.core import s2fp8 as ts2
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

FMTS = ("e5m2", "e4m3")
JQ = {"e5m2": jnp.float8_e5m2, "e4m3": jnp.float8_e4m3fn}


def _ordinal(codes_u8: np.ndarray) -> np.ndarray:
    u = codes_u8.astype(np.int32)
    return np.where(u >= 0x80, -(u & 0x7F), u & 0x7F)


def _codes_j(payload) -> np.ndarray:
    return np.asarray(jax.lax.bitcast_convert_type(payload, jnp.uint8))


def _codes_t(payload: torch.Tensor) -> np.ndarray:
    return payload.view(torch.uint8).numpy()


def _sample(n, scale, seed):
    return (np.random.default_rng(seed).standard_normal(n) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("fmt", FMTS)
def test_degenerate_stats_exact(fmt):
    """All-zero -> identity (1, 0); constant |x| -> pure shift pinning the
    max at the format's target; both equal to the reference bit for bit."""
    tm = js2.FMT_TARGET_MAX[fmt]
    cases = [np.zeros(64, np.float32),
             np.full(64, 0.375, np.float32),
             np.where(np.arange(64) % 2 == 0, -3.0, 3.0).astype(np.float32),
             np.array([0.0] * 10 + [2.0 ** -20] * 5, np.float32)]
    for x in cases:
        ja, jb = js2.compute_stats(jnp.asarray(x), target_max=tm)
        tab = ts2.compute_stats(torch.from_numpy(x), tm)
        assert tab[0].item() == float(ja) and tab[1].item() == float(jb)
    a, b = ts2.compute_stats(torch.zeros(8), tm)
    assert (a.item(), b.item()) == (1.0, 0.0)
    a, b = ts2.compute_stats(torch.full((8,), 0.25), tm)
    assert (a.item(), b.item()) == (1.0, tm + 2.0)


@pytest.mark.parametrize("fmt", FMTS)
def test_fp8_casts_bitwise(fmt):
    """torch's RNE cast == ml_dtypes' cast for every in-range f32 value
    class: normals, subnormals, exact ties, zeros, the max finite."""
    fmax = js2.FMT_MAX_FINITE[fmt]
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.integers(-8, 4, 4096),
        np.array([0.0, -0.0, fmax, -fmax, 2.0 ** -16, 2.0 ** -17, 2.0 ** -9,
                  2.0 ** -10, 1.125, 1.375, 1.0625, 3.0 * 2.0 ** -17])]
    ).astype(np.float32)
    x = np.clip(x, -fmax, fmax)
    j = _codes_j(jnp.asarray(x).astype(JQ[fmt]))
    t = _codes_t(torch.from_numpy(x).to(ts2.FMT_QDTYPE[fmt]))
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_stats_match_reference(scale):
    """(alpha, beta) of the port's reduction within 1e-5 relative."""
    for fmt in FMTS:
        x = _sample(1 << 16, scale, seed=2)
        ja, jb = js2.compute_stats_jit(jnp.asarray(x),
                                       target_max=js2.FMT_TARGET_MAX[fmt])
        tab = ts2.compute_stats(torch.from_numpy(x), js2.FMT_TARGET_MAX[fmt])
        np.testing.assert_allclose(tab.numpy(), [float(ja), float(jb)],
                                   rtol=1e-5)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
@pytest.mark.parametrize("fmt", FMTS)
def test_quantize_flip_budget_at_shared_stats(fmt, scale):
    """Same (alpha, beta) on both sides: payload codes at most one grid step
    apart, in at most 1e-4 of the elements; dequantized values of equal
    codes agree to f32 rounding (rtol 1e-5)."""
    x = _sample(1 << 16, scale, seed=3)
    ja, jb = js2.compute_stats_jit(jnp.asarray(x),
                                   target_max=js2.FMT_TARGET_MAX[fmt])
    jt = js2.quantize(jnp.asarray(x), stats=(ja, jb), fmt=fmt)
    tt = ts2.quantize(torch.from_numpy(x), stats=(float(ja), float(jb)),
                      fmt=fmt)
    jc, tc = _codes_j(jt.payload), _codes_t(tt.payload)
    step = np.abs(_ordinal(jc) - _ordinal(tc))
    assert step.max() <= 1
    assert np.mean(step != 0) <= 1e-4
    same = jc == tc
    np.testing.assert_allclose(ts2.dequantize(tt).numpy()[same],
                               np.asarray(js2.dequantize(jt))[same],
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", FMTS)
def test_dequant_of_quant_is_truncate_bitwise(fmt, dtype):
    """dequantize(quantize(x, s)) == truncate_value(x, s), bit for bit,
    including saturation under stale stats (|x| beyond the stats' range)."""
    x = torch.from_numpy(_sample(1 << 14, 1.0, seed=4)).to(dtype)
    ab = ts2.compute_stats(x[: 1 << 10], ts2.FMT_TARGET_MAX[fmt])
    trunc = (ts2.truncate_value if fmt == "e5m2"
             else ts2.truncate_value_e4m3)(x, stats=ab)
    deq = ts2.dequantize(ts2.quantize(x, stats=ab, fmt=fmt), dtype)
    assert trunc.dtype == dtype
    assert torch.equal(deq.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       trunc.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))


def test_s2fp8_tensor_carries_stats_and_format():
    x = torch.from_numpy(_sample(96, 1.0, seed=5)).reshape(8, 12)
    t = ts2.quantize(x, fmt="e4m3")
    assert t.payload.dtype == torch.float8_e4m3fn and t.fmt == "e4m3"
    r = t.reshape(12, 8)
    assert r.shape == (12, 8) and r.ab is t.ab
    assert t.alpha.item() == t.ab[0].item() and t.beta.item() == t.ab[1].item()
