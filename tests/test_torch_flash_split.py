"""The flash kernels' compensated TF32 arithmetic, rehearsed on the CPU.

The CUDA flash kernels (``repro_torch/csrc/flash_attention.cu``) run every
product on TF32 tensor cores in three passes: each f32 operand is split
into (hi, lo) = (tf32(x), tf32(x - hi)), truncated toward zero, and a
product is taken as lo.hi + hi.lo + hi.hi.  Payload operands take the
split from a per-block table of every code's (hi, lo) pair.  Here, in
plain torch (``kernels.ref.tf32_round`` / ``split_tf32``):

* the split reproduces every finite table value of e5m2 and e4m3 at
  several (alpha, beta) to within 2^-21 relative (absolutely below 2^-100,
  where f32 runs out of bits);
* an emulation of the kernels' forward (64-key tiles, online softmax, all
  products 3-pass; the bf16 form with its exact operands' passes left out)
  and backward (all five products 3-pass) stays inside the tolerances the
  kernels are held to on the card against the f32 plain versions: payload
  output codes at most one grid step apart in at most 1% of the elements
  and |lse| error <= 1e-4; plain f32 output rtol 2e-4, atol 2e-5, bf16
  rtol 1e-2, atol 1e-3; dq, dk, dv within 1e-4 * max |plain|.

Shapes: head dims 32, 64, 80 and 128, grouped K/V heads (g = 2), causal
and windowed, Sq != Sk.
"""
import math

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro_torch.core import s2fp8
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

MASK = -1e30


def _mm3(a, b, a_exact=False, b_exact=False):
    """a @ b as the kernels take it: lo.hi + hi.lo + hi.hi on TF32 halves;
    an operand exact in TF32 (bf16 values) has lo = 0 and no pass."""
    ah, al = ref.split_tf32(a)
    bh, bl = ref.split_tf32(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    if not a_exact:
        out = out + al @ bh
    if not b_exact:
        out = out + ah @ bl
    return out + ah @ bh


def _mask(sq, sk, causal, window, q0=0, k0=0, nq=None, nk=None):
    nq = sq if nq is None else nq
    nk = sk if nk is None else nk
    qpos = torch.arange(q0, q0 + nq)[:, None] + (sk - sq)
    kpos = torch.arange(k0, k0 + nk)[None, :]
    m = (kpos < sk) & (qpos > -sq - sk)      # [nq, nk]
    if causal:
        m &= kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def fwd_emulated(q, k, v, *, g, causal=True, window=None, exact=False,
                 tile=64):
    """The forward kernel's arithmetic: q [BH, Sq, d], k/v [BH/g, Sk, d]
    (f32 values); key tiles of ``tile`` rows, scores and PV 3-pass (for
    bf16 values, QK^T one pass and PV two), the online softmax in f32."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    kk, vv = k.repeat_interleave(g, 0), v.repeat_interleave(g, 0)
    scale = 1.0 / math.sqrt(d)
    m = torch.full((bh, sq, 1), MASK)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    for k0 in range(0, sk, tile):
        kt, vt = kk[:, k0:k0 + tile], vv[:, k0:k0 + tile]
        vis = _mask(sq, sk, causal, window, k0=k0, nk=kt.shape[1])
        s = _mm3(q, kt.transpose(1, 2), exact, exact) * scale
        s = torch.where(vis, s, MASK)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(vis, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _mm3(p, vt, False, exact)
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out, (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]


def bwd_emulated(q, k, v, gout, lse, delta, *, g, causal=True, window=None):
    """The backward kernels' arithmetic, every product 3-pass: raw dq and
    per-query-head dk, dv."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    kk, vv = k.repeat_interleave(g, 0), v.repeat_interleave(g, 0)
    scale = 1.0 / math.sqrt(d)
    vis = _mask(sq, sk, causal, window)
    s = _mm3(q, kk.transpose(1, 2)) * scale
    p = torch.where(vis, torch.exp(s - lse[..., None]), 0.0)
    dp = _mm3(gout, vv.transpose(1, 2))
    ds = p * (dp - delta[..., None]) * scale
    return (_mm3(ds, kk), _mm3(ds.transpose(1, 2), q),
            _mm3(p.transpose(1, 2), gout))


def _payloads(rng, shapes, fmt="e5m2", scales=None):
    out = []
    for i, shape in enumerate(shapes):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        if scales:
            x = x * scales[i]
        t = s2fp8.quantize(x, fmt=fmt)
        out.append((t.payload, t.ab))
    return out


def _ordinal(payload):
    u = payload.view(torch.uint8).int()
    return torch.where(u >= 0x80, -(u & 0x7F), u & 0x7F)


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
@pytest.mark.parametrize("ab", [(1.0, 0.0), (0.6, 3.25), (2.5, -7.0),
                                (0.25, 1.5)])
def test_split_reproduces_every_table_value(fmt, ab):
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    payload = codes.view(s2fp8.FMT_QDTYPE[fmt])
    stats = torch.tensor(ab, dtype=torch.float32)
    table = ref.s2fp8_dequant_ref(payload, stats)
    hi, lo = ref.split_tf32(table)
    finite = torch.isfinite(table)
    # every code but e5m2's two infinities (NaN codes decode to 0)
    assert int(finite.sum()) == {"e5m2": 254, "e4m3": 256}[fmt]
    for half in (hi, lo):
        assert not (half[finite].view(torch.int32) & 0x1FFF).any()
    v = table[finite]
    err = ((hi + lo)[finite] - v).abs()
    # relative where lo is a normal f32 too; below, f32 itself runs out of
    # bits and the error is absolute and negligible
    normal = v.abs() >= 2.0 ** -100
    assert bool((err[normal] <= 2.0 ** -21 * v[normal].abs()).all())
    assert bool((err[~normal] <= 2.0 ** -120).all())


CASES = [  # (d, sq, sk, g, causal, window)
    (32, 100, 100, 2, True, None),
    (64, 130, 130, 1, True, 48),
    (80, 70, 150, 2, True, None),
    (128, 96, 96, 2, True, 40),
]


@pytest.mark.parametrize("d,sq,sk,g,causal,window", CASES)
def test_emulated_payload_forward_within_card_tolerance(d, sq, sk, g,
                                                        causal, window):
    rng = np.random.default_rng(d + sq)
    bkv = 2
    (pq, qab), (pk, kab), (pv, vab) = _payloads(
        rng, [(bkv * g, sq, d), (bkv, sk, d), (bkv, sk, d)])
    deq = [ref.s2fp8_dequant_ref(p, ab) for p, ab in
           ((pq, qab), (pk, kab), (pv, vab))]
    kw = dict(g=g, causal=causal, window=window)
    raw, lse = fa.qflash_fwd_plain(pq, pk, pv, qab, kab, vab, **kw)
    oab = s2fp8.compute_stats(raw)
    want, _ = fa.qflash_fwd_plain(pq, pk, pv, qab, kab, vab, out_ab=oab,
                                  **kw)
    got, glse = fwd_emulated(*deq, **kw)
    got = ref.s2fp8_truncate_ref(got, stats=oab)
    steps = (_ordinal(s2fp8.quantize(got, stats=oab).payload)
             - _ordinal(s2fp8.quantize(want, stats=oab).payload)).abs()
    assert steps.max() <= 1 and (steps != 0).float().mean() <= 1e-2
    assert (glse - lse).abs().max() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,sq,sk,g,causal,window", CASES)
def test_emulated_plain_forward_within_card_tolerance(dtype, d, sq, sk, g,
                                                      causal, window):
    rng = np.random.default_rng(7 * d + sq)

    def val(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(dtype).float()

    q, k, v = val(g, sq, d), val(1, sk, d), val(1, sk, d)
    want, _ = fa.flash_fwd_reference(q[None, None], k[None], v[None],
                                     causal=causal, window=window)
    got, _ = fwd_emulated(q, k, v, g=g, causal=causal, window=window,
                          exact=dtype == torch.bfloat16)
    got, want = got.to(dtype).float(), want[0, 0].to(dtype).float()
    rtol, atol = ((2e-4, 2e-5) if dtype == torch.float32 else (1e-2, 1e-3))
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("d,sq,sk,g,causal,window", CASES)
def test_emulated_backward_within_card_tolerance(d, sq, sk, g, causal,
                                                 window):
    rng = np.random.default_rng(3 * d + sk)
    bkv = 2
    (pq, qab), (pk, kab), (pv, vab), (pg, gab) = _payloads(
        rng, [(bkv * g, sq, d), (bkv, sk, d), (bkv, sk, d),
              (bkv * g, sq, d)], scales=[1.0, 1.0, 1.0, 1e-3])
    kw = dict(g=g, causal=causal, window=window)
    out, lse = fa.qflash_fwd_plain(pq, pk, pv, qab, kab, vab, **kw)
    oab = s2fp8.compute_stats(out)
    po = s2fp8.quantize(out, stats=oab).payload
    delta = (ref.s2fp8_dequant_ref(pg, gab)
             * ref.s2fp8_dequant_ref(po, oab)).sum(-1)
    want = fa.qflash_bwd_plain(pq, pk, pv, pg, qab, kab, vab, gab, lse,
                               delta, **kw)
    deq = [ref.s2fp8_dequant_ref(p, ab) for p, ab in
           ((pq, qab), (pk, kab), (pv, vab), (pg, gab))]
    got = bwd_emulated(*deq, lse, delta, **kw)
    for x, y in zip(got, want):
        assert x.shape == y.shape
        assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item()
