"""The port's public kernel API (``repro_torch.kernels.ops``) and the plain
flash forward against the JAX package, on the CPU.

Each ``ops`` function runs on CPU tensors, where it takes the oracle of
``kernels/ref.py``, against the JAX ``ops`` function with
``use_pallas=False`` on the same numpy inputs.  ``flash_attention_plain``
(the plain version of the port's flash forward kernel) is held against
``flash_attention_pallas`` in interpret mode at bq = bk = 64, over the
masks of ``tests/test_kernels.py``.  Tolerances are stated beside each
comparison.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import Policy as JaxPolicy
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch import kernels
from repro_torch.core.policy import Policy
from repro_torch.kernels import flash_attention as fkern
from repro_torch.kernels import ops
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")


def _codes(payload) -> np.ndarray:
    """Signed ordinal of 8-bit codes (neighbouring grid points differ by
    1), from a JAX or a torch payload."""
    if isinstance(payload, torch.Tensor):
        u = payload.view(torch.uint8).numpy().astype(np.int32)
    else:
        u = np.asarray(payload).view(np.uint8).astype(np.int32)
    return np.where(u >= 0x80, -(u & 0x7F), u & 0x7F)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return {"x": (rng.standard_normal((96, 160)) * 0.05).astype(np.float32),
            "w": (rng.standard_normal((160, 72)) / 12).astype(np.float32)}


def test_quant_and_dequant_match_jax_ops(data):
    """Stats within 1e-5 relative (two f32 reductions of log2|x| in
    different orders, and XLA's log2 is log * 1/ln2); payload codes at most
    one grid step apart in at most 1e-3 of the elements; the dequantized
    values of one payload and one (alpha, beta) within 1e-6 relative (the
    inverse map's log2 / exp2 in the last ulp)."""
    x = data["x"]
    pj, aj, bj = jops.s2fp8_quant(jnp.asarray(x), use_pallas=False)
    pt, at, bt = ops.s2fp8_quant(_t(x))
    assert pt.dtype == torch.float8_e5m2 and pt.shape == x.shape
    np.testing.assert_allclose([float(at), float(bt)],
                               [float(aj), float(bj)], rtol=1e-5)
    d = np.abs(_codes(pj) - _codes(pt))
    assert d.max() <= 1 and (d != 0).mean() <= 1e-3
    # one payload, one (alpha, beta): the JAX side's
    pay = _t(np.asarray(pj).view(np.uint8)).view(torch.float8_e5m2)
    dj = jops.s2fp8_dequant(pj, aj, bj, use_pallas=False)
    dt = ops.s2fp8_dequant(pay, torch.tensor(float(aj)),
                           torch.tensor(float(bj)))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
@pytest.mark.parametrize("given_stats", [True, False])
def test_truncate_matches_jax_ops(data, fmt, given_stats):
    """Given (alpha, beta), or with each side's exact stats: read back as
    codes under the stats each side used, the truncated values are at most
    one grid step apart in at most 1e-3 of the elements; where the codes
    agree the values agree within 1e-5 relative (the grid point's value
    comes from log2 / exp2, which differ from XLA's in the last ulp)."""
    from repro_torch.core import s2fp8
    x = data["x"]
    sj = st = None
    if given_stats:
        _, a, b = jops.s2fp8_quant(jnp.asarray(x), use_pallas=False)
        sj = st = (float(a), float(b))
    yj = np.asarray(jops.s2fp8_truncate(jnp.asarray(x), stats=sj, fmt=fmt,
                                        use_pallas=False))
    yt = ops.s2fp8_truncate(_t(x), stats=st, fmt=fmt)
    assert yt.dtype == torch.float32
    tgt = s2fp8.FMT_TARGET_MAX[fmt]
    ab_j = s2fp8.as_stats(sj) if sj else s2fp8.as_stats(
        [float(v) for v in jref.s2fp8.compute_stats(jnp.asarray(x), tgt)])
    ab_t = s2fp8.as_stats(st) if st else s2fp8.compute_stats(_t(x), tgt)
    cj = _codes(s2fp8.quantize(_t(yj), stats=ab_j, fmt=fmt).payload)
    ct = _codes(s2fp8.quantize(yt, stats=ab_t, fmt=fmt).payload)
    d = np.abs(cj - ct)
    assert d.max() <= 1 and (d != 0).mean() <= 1e-3
    same = d == 0
    np.testing.assert_allclose(yt.numpy()[same], yj[same], rtol=1e-5)


def test_matmul_matches_jax_ops(data):
    """One pair of payloads and stats (the JAX side's): the f32 products
    within 1e-5 relative of the largest output (summation order)."""
    pa, aa, ba = jops.s2fp8_quant(jnp.asarray(data["x"]), use_pallas=False)
    pb, ab, bb = jops.s2fp8_quant(jnp.asarray(data["w"]), use_pallas=False)
    yj = np.asarray(jops.s2fp8_matmul(pa, aa, ba, pb, ab, bb,
                                      use_pallas=False))

    def pay(p):
        return _t(np.asarray(p).view(np.uint8)).view(torch.float8_e5m2)

    yt = ops.s2fp8_matmul(pay(pa), torch.tensor(float(aa)),
                          torch.tensor(float(ba)), pay(pb),
                          torch.tensor(float(ab)), torch.tensor(float(bb)))
    assert yt.shape == (96, 72)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                               atol=1e-5 * np.abs(yj).max())


@pytest.mark.parametrize("causal,window,sq,sk", [
    (True, None, 64, 64), (False, None, 64, 64), (True, 16, 64, 64),
    (True, None, 32, 96), (True, None, 96, 32)])
def test_flash_attention_oracle_matches_jax_ops(causal, window, sq, sk):
    """``ops.flash_attention`` on the CPU is ``ref.attention_ref``: within
    1e-5 (f32 softmax and products in another order).  A row that sees no
    key (Sq > Sk, causal) is NaN on both sides, the oracles' -inf fill; the
    port's plain flash forward, like the kernels, gives 0 there."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 3, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, 3, sk, 16)).astype(np.float32)
    v = rng.standard_normal((2, 3, sk, 16)).astype(np.float32)
    oj = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal,
                                         window=window, use_pallas=False))
    ot = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             window=window).numpy()
    np.testing.assert_allclose(ot, oj, rtol=1e-5, atol=1e-5)
    hidden = max(0, sq - sk) if causal else 0
    assert np.isnan(ot[:, :, :hidden]).all() and np.isnan(oj[:, :, :hidden]).all()
    assert not np.isnan(ot[:, :, hidden:]).any()
    plain = fkern.flash_attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                        window=window).numpy()
    assert not plain[:, :, :hidden].any()
    np.testing.assert_allclose(plain[:, :, hidden:], ot[:, :, hidden:],
                               rtol=1e-5, atol=1e-5)


_PALLAS_CASES = (
    [((1, 2, 256, 64), (1, 2, 256, 64), causal, window, "float32")
     for causal, window in ((True, None), (False, None), (True, 64))]
    + [((2, 4, 128, 32), (2, 4, 128, 32), causal, window, "float32")
       for causal, window in ((True, None), (False, None), (True, 64))]
    + [((1, 2, 64, 32), (1, 2, 256, 32), True, None, "float32"),
       ((1, 2, 128, 64), (1, 2, 128, 64), True, None, "bfloat16")])


@pytest.mark.parametrize("qshape,kshape,causal,window,dtype", _PALLAS_CASES)
def test_flash_attention_plain_vs_pallas_interpret(qshape, kshape, causal,
                                                   window, dtype):
    """The cases of tests/test_kernels.py (causal, non-causal, windowed,
    Sq < Sk, bf16) at bq = bk = 64 in interpret mode.  f32 within rtol
    2e-4, atol 2e-5 (the reference's tolerance for its kernel against the
    oracle: online-softmax blocking of 64 there, 512 here); bf16 within
    1e-2 (one bf16 rounding of f32 results)."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in (qshape, kshape, kshape))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    oj = flash_attention_pallas(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                jnp.asarray(v, jdt), causal=causal,
                                window=window, bq=64, bk=64, interpret=True)
    kernels.reset_counts()
    ot = fkern.flash_attention(_t(q).to(tdt), _t(k).to(tdt), _t(v).to(tdt),
                               causal=causal, window=window)
    assert ot.dtype == tdt
    assert kernels.counts()["flash_fwd"] == {"launches": 0, "plain_calls": 1}
    tol = (dict(rtol=2e-4, atol=2e-5) if dtype == "float32"
           else dict(rtol=1e-2, atol=1e-2))
    np.testing.assert_allclose(ot.float().numpy(),
                               np.asarray(oj, np.float32), **tol)


def test_use_kernel_true_on_cpu_tensors_raises(data):
    x = _t(data["x"])
    p, a, b = ops.s2fp8_quant(x)
    q = torch.zeros(1, 1, 4, 8)
    calls = [lambda: ops.s2fp8_quant(x, use_kernel=True),
             lambda: ops.s2fp8_dequant(p, a, b, use_kernel=True),
             lambda: ops.s2fp8_truncate(x, use_kernel=True),
             lambda: ops.s2fp8_matmul(p, a, b, p.T.contiguous(), a, b,
                                      use_kernel=True),
             lambda: ops.flash_attention(q, q, q, use_kernel=True)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_policy_default_is_the_references():
    assert Policy().mode == JaxPolicy().mode == "fp32"
    assert Policy().gemm_mode == JaxPolicy().gemm_mode == "auto"


def test_oracles_are_the_references_on_cpu(data):
    """The ref oracles the ops take on the CPU: ``selective_scan_ref`` and
    ``attention_ref`` against ``repro.kernels.ref``, within 1e-5."""
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 12, 40)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, 12, 40)) - 1.0)
                  ).astype(np.float32)
    bm, cm = (rng.standard_normal((2, 12, 4)).astype(np.float32)
              for _ in range(2))
    a = -np.exp(rng.standard_normal((40, 4)) * 0.3).astype(np.float32)
    d = np.ones(40, np.float32)
    yj, hj = jref.selective_scan_ref(*(jnp.asarray(t) for t in
                                       (x, dt, bm, cm, a, d)))
    yt, ht = tref.selective_scan_ref(*(_t(t) for t in (x, dt, bm, cm, a, d)))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-5,
                               atol=1e-5)
