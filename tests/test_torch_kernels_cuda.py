"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  Marked ``cuda``: without a GPU every test skips (decided inside the
fixture, so every worker collects the same tests).  Run on a GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: quantize / truncate are bit for bit (same maps, same rounding
of each step; up to one grid step in 1e-4 of the elements is allowed for
the math library); dequantize within 1e-6 relative; GEMM raw output (NN,
NT, TN) within 1e-5 * (|A| @ |B|), epilogue and flash outputs at most one
grid step apart in at most 1e-3 / 1e-2 of the elements; flash backward
dq / dk / dv within 1e-4 * max|plain|; paged decode allclose 1e-4
relative + 1e-5 absolute (at serve's shape with positions on both sides of
the kernel's split boundaries, at G = 3 and 5 with hd 128, beside dead
slots, and the same bits on a second launch); truncate-apply bit for bit
dequant(quant_apply(x)) in x's dtype (ragged sizes, views off a 16-byte
boundary); the batched GEMM as the 2-D one, raw within
1e-5 * (|A| @ |B|) summed over each output's groups; the stats kernel's
max and count equal to the plain version's, its sum within 1e-6 relative
(f64 sums in another order), (alpha, beta) within 4 ulp, and the
quantize-with-stats and fused truncate kernels bit for bit the
quantize-apply and truncate-apply kernels under the stats kernel's
(alpha, beta), on both sides of what they keep across their grid barrier
and at unaligned offsets; the stats kernel's ticket back at 0 after every
launch, on two streams; the selective scan's y and final h within 1e-5 * max
|plain| (the same rounded ops on both sides, the sum over the states in
another order), and the same bits on a second launch, per channel and per
head up to 64 states; the scan's backward within 1e-4 * max |plain| of
autograd through the plain version, the same bits on a second launch; the
plain flash
forward allclose at rtol 2e-4, atol 2e-5
in f32 (the reference's tolerance for its kernel against the oracle) and
rtol 1e-2, atol 1e-3 in bf16 (one bf16 rounding of f32 results), a row
that sees no key exactly 0 on both sides.  The flash kernels also give
the same bits on two launches with the same inputs (no float atomics),
and hold their tolerances at tile edges (head dims 1, 8 and 72, one query
row, ragged Sq != Sk), at d = 128 with grouped K/V heads, and at the head
dims above 128 (136, 160, 192 and 256: two column chunks of the output);
the paged decode at every head dim its padded lane groups take (16, 48,
80, 160, 192, 256 and 240).  The payload GEMM is held on both
of its paths (small M split over K, large M on tensor cores in 64- and
128-row blocks), at ragged and padded shapes, and gives the same bits on
two launches on each path.
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import s2fp8
from repro_torch.kernels import (flash_attention, paged_attention,
                                 s2fp8_matmul, s2fp8_quant, selective_scan)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    kernels.reset_counts()
    return torch.device("cuda", 0)


def _ordinal(payload):
    u = payload.view(torch.uint8).int()
    return torch.where(u >= 0x80, -(u & 0x7F), u & 0x7F)


def _steps(a, b, ab, fmt="e5m2"):
    qa = s2fp8.quantize(a.float(), stats=ab, fmt=fmt).payload
    qb = s2fp8.quantize(b.float(), stats=ab, fmt=fmt).payload
    return (_ordinal(qa) - _ordinal(qb)).abs()


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_truncate_kernels(dev, fmt, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(1000, 333, generator=g, device=dev) * 0.1).to(dtype)
    ab = s2fp8.compute_stats(x, s2fp8.FMT_TARGET_MAX[fmt])
    pk = s2fp8_quant.quant_apply(x, ab, fmt)
    pp = s2fp8_quant.quant_apply_plain(x, ab, fmt)
    d = (_ordinal(pk) - _ordinal(pp)).abs()
    assert d.max() <= 1 and (d != 0).float().mean() <= 1e-4
    tk = s2fp8_quant.truncate_apply(x, ab, fmt)
    tp = s2fp8_quant.truncate_apply_plain(x, ab, fmt)
    assert tk.dtype == dtype
    d = _steps(tk, tp, ab, fmt)
    assert d.max() <= 1 and (d != 0).float().mean() <= 1e-4
    assert kernels.counts()["quant_apply"]["launches"] == 1


@pytest.mark.parametrize("mkn", [(8, 2304, 576), (333, 130, 77)])
def test_gemm_kernel(dev, mkn):
    m, k, n = mkn
    g = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn(m, k, generator=g, device=dev)
    b = torch.randn(k, n, generator=g, device=dev) / k ** 0.5
    aab, bab = s2fp8.compute_stats(a), s2fp8.compute_stats(b)
    qa, qb = s2fp8_quant.quant_apply(a, aab), s2fp8_quant.quant_apply(b, bab)
    raw_k = s2fp8_matmul.qmatmul_nn(qa, aab, qb, bab)
    raw_p = s2fp8_matmul.qmatmul_plain(qa, aab, qb, bab)
    da = s2fp8.dequantize(s2fp8.S2FP8Tensor(qa, aab))
    db = s2fp8.dequantize(s2fp8.S2FP8Tensor(qb, bab))
    assert bool(((raw_k - raw_p).abs() <= 1e-5 * (da.abs() @ db.abs())
                 + 1e-30).all())
    oab = s2fp8.compute_stats(raw_p)
    d = _steps(s2fp8_matmul.qmatmul_nn(qa, aab, qb, bab, oab),
               s2fp8_matmul.qmatmul_plain(qa, aab, qb, bab, oab), oab)
    assert d.max() <= 1 and (d != 0).float().mean() <= 1e-3


@pytest.mark.parametrize("g,d,s", [(1, 64, 200), (2, 80, 130), (1, 32, 64)])
def test_qflash_kernel(dev, g, d, s):
    gen = torch.Generator(device=dev).manual_seed(2)
    bkv = 3
    q = torch.randn(bkv * g, s, d, generator=gen, device=dev)
    k = torch.randn(bkv, s, d, generator=gen, device=dev)
    v = torch.randn(bkv, s, d, generator=gen, device=dev)
    sts = [s2fp8.compute_stats(t) for t in (q, k, v)]
    pq, pk, pv = (s2fp8_quant.quant_apply(t, ab) for t, ab in zip((q, k, v),
                                                                   sts))
    raw, _ = flash_attention.qflash_fwd_plain(pq, pk, pv, *sts, g=g)
    oab = s2fp8.compute_stats(raw)
    ok, lk = flash_attention.qflash_fwd(pq, pk, pv, *sts, g=g, out_ab=oab)
    op, lp = flash_attention.qflash_fwd_plain(pq, pk, pv, *sts, g=g,
                                              out_ab=oab)
    dd = _steps(ok, op, oab)
    assert dd.max() <= 1 and (dd != 0).float().mean() <= 1e-2
    assert (lk - lp).abs().max() <= 1e-4


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_paged_kernel(dev, fmt):
    gen = torch.Generator(device=dev).manual_seed(3)
    b, kvh, g, hd, blk, max_b, nb = 4, 2, 3, 64, 16, 4, 9
    q = torch.randn(b, kvh, g, hd, generator=gen, device=dev)
    kf = torch.randn(nb, kvh, blk, hd, generator=gen, device=dev)
    vf = torch.randn(nb, kvh, blk, hd, generator=gen, device=dev)
    kab = torch.tensor([4.0, 1.5], device=dev)
    vab = torch.tensor([3.0, -0.5], device=dev)
    kp = s2fp8_quant.quant_apply(kf, kab, fmt)
    vp = s2fp8_quant.quant_apply(vf, vab, fmt)
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0],
                          [7, 8, 1, 2]], dtype=torch.int32, device=dev)
    pos = torch.tensor([5, 33, 0, 60], dtype=torch.int32, device=dev)
    ok = paged_attention.paged_decode_attention(q, kp, vp, kab, vab, table,
                                                pos, fmt)
    op = paged_attention.paged_decode_plain(q, kp, vp, kab, vab, table, pos,
                                            fmt)
    assert torch.isfinite(ok).all()
    assert bool(((ok - op).abs() <= 1e-4 * op.abs() + 1e-5).all())


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_dequant_kernel(dev, fmt):
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(777, 333, generator=g, device=dev) * 0.1
    ab = s2fp8.compute_stats(x, s2fp8.FMT_TARGET_MAX[fmt])
    p = s2fp8_quant.quant_apply(x, ab, fmt)
    dk = s2fp8_quant.dequant(p, ab)
    dp = s2fp8_quant.dequant_plain(p, ab)
    assert bool(((dk - dp).abs() <= 1e-6 * dp.abs()).all())
    assert kernels.counts()["dequant"] == {"launches": 1, "plain_calls": 1}


@pytest.mark.parametrize("layout", ["nt", "tn"])
@pytest.mark.parametrize("mkn", [(333, 130, 77), (2048, 576, 256)])
def test_gemm_nt_tn_kernels(dev, layout, mkn):
    m, k, n = mkn
    g = torch.Generator(device=dev).manual_seed(5)
    a = torch.randn(*((m, k) if layout == "nt" else (k, m)), generator=g,
                    device=dev)
    b = torch.randn(*((n, k) if layout == "nt" else (k, n)), generator=g,
                    device=dev) / k ** 0.5
    aab, bab = s2fp8.compute_stats(a), s2fp8.compute_stats(b)
    qa, qb = s2fp8_quant.quant_apply(a, aab), s2fp8_quant.quant_apply(b, bab)
    kernel = getattr(s2fp8_matmul, f"qmatmul_{layout}")
    plain = getattr(s2fp8_matmul, f"qmatmul_{layout}_plain")
    da = s2fp8.dequantize(s2fp8.S2FP8Tensor(qa, aab))
    db = s2fp8.dequantize(s2fp8.S2FP8Tensor(qb, bab))
    lhs, rhs = (da, db.t()) if layout == "nt" else (da.t(), db)
    raw_k, raw_p = kernel(qa, aab, qb, bab), plain(qa, aab, qb, bab)
    assert bool(((raw_k - raw_p).abs() <= 1e-5 * (lhs.abs() @ rhs.abs())
                 + 1e-30).all())
    oab = s2fp8.compute_stats(raw_p)
    d = _steps(kernel(qa, aab, qb, bab, oab), plain(qa, aab, qb, bab, oab),
               oab)
    assert d.max() <= 1 and (d != 0).float().mean() <= 1e-3
    assert kernels.counts()[f"qmatmul_{layout}"]["launches"] == 2


@pytest.mark.parametrize("g,d,s,window", [(1, 64, 512, None),
                                          (2, 32, 200, 64),
                                          (1, 80, 130, None)])
def test_qflash_bwd_kernel(dev, g, d, s, window):
    gen = torch.Generator(device=dev).manual_seed(6)
    bkv = 3
    q = torch.randn(bkv * g, s, d, generator=gen, device=dev)
    k = torch.randn(bkv, s, d, generator=gen, device=dev)
    v = torch.randn(bkv, s, d, generator=gen, device=dev)
    dout = torch.randn(bkv * g, s, d, generator=gen, device=dev) * 1e-3
    sts = [s2fp8.compute_stats(t) for t in (q, k, v, dout)]
    pq, pk, pv, pg = (s2fp8_quant.quant_apply(t, ab)
                      for t, ab in zip((q, k, v, dout), sts))
    out, lse = flash_attention.qflash_fwd_plain(pq, pk, pv, *sts[:3], g=g,
                                                window=window)
    oab = s2fp8.compute_stats(out)
    po = s2fp8_quant.quant_apply(out, oab)
    delta = (s2fp8.dequantize(s2fp8.S2FP8Tensor(pg, sts[3]))
             * s2fp8.dequantize(s2fp8.S2FP8Tensor(po, oab))).sum(-1)
    args = (pq, pk, pv, pg, *sts, lse, delta)
    got = flash_attention.qflash_bwd(*args, g=g, window=window)
    want = flash_attention.qflash_bwd_plain(*args, g=g, window=window)
    for x, y in zip(got, want):
        assert bool(torch.isfinite(x).all())
        assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item()
    assert kernels.counts()["qflash_bwd"] == {"launches": 1,
                                              "plain_calls": 1}


@pytest.mark.parametrize("layout,ga,gb,out_batch,mkn", [
    ("nn", 6, 6, None, (200, 130, 77)),
    ("nt", 6, 6, None, (200, 130, 77)),
    ("tn", 6, 6, None, (77, 200, 130)),
    ("nn", 12, 6, None, (64, 256, 96)),       # broadcast B (becd,edf)
    ("nt", 12, 6, None, (64, 96, 256)),       # its dA
    ("tn", 12, 12, 6, (256, 64, 96)),         # its dW: groups summed
    ("tn", 3, 12, 6, (100, 40, 33)),          # broadcast A + group sum
    ("nn", 8, 4, None, (64, 200, 96)),        # grouped routing, M = 64
    ("nt", 8, 4, None, (64, 96, 200)),        # its dA
    ("tn", 8, 8, 4, (200, 64, 96)),           # its dW over 2 row groups
])
def test_batched_gemm_kernel(dev, layout, ga, gb, out_batch, mkn):
    m, k, n = mkn
    gen = torch.Generator(device=dev).manual_seed(7)
    ash = {"nn": (m, k), "nt": (m, k), "tn": (k, m)}[layout]
    bsh = {"nn": (k, n), "nt": (n, k), "tn": (k, n)}[layout]
    a = torch.randn(ga, *ash, generator=gen, device=dev)
    b = torch.randn(gb, *bsh, generator=gen, device=dev) / k ** 0.5
    aab, bab = s2fp8.compute_stats(a), s2fp8.compute_stats(b)
    qa, qb = s2fp8_quant.quant_apply(a, aab), s2fp8_quant.quant_apply(b, bab)
    kw = dict(layout=layout, out_batch=out_batch)
    raw_k = s2fp8_matmul.qmatmul_batched(qa, aab, qb, bab, **kw)
    raw_p = s2fp8_matmul.qmatmul_batched_plain(qa, aab, qb, bab, **kw)
    # |A| @ |B| through the plain version on |payload| values
    scale = s2fp8_matmul.qmatmul_batched_plain(
        _abs_payload(qa), aab, _abs_payload(qb), bab, **kw)
    assert raw_k.shape == raw_p.shape
    assert bool(((raw_k - raw_p).abs() <= 1e-5 * scale + 1e-30).all())
    oab = s2fp8.compute_stats(raw_p)
    d = _steps(s2fp8_matmul.qmatmul_batched(qa, aab, qb, bab, oab, **kw),
               s2fp8_matmul.qmatmul_batched_plain(qa, aab, qb, bab, oab,
                                                  **kw), oab)
    assert d.max() <= 1 and (d != 0).float().mean() <= 1e-3
    assert kernels.counts()["qmatmul_batched"] == {"launches": 2,
                                                   "plain_calls": 3}


def _gemm_operands(dev, layout, m, k, n, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(*((k, m) if layout == "tn" else (m, k)), generator=gen,
                    device=dev)
    b = torch.randn(*((n, k) if layout == "nt" else (k, n)), generator=gen,
                    device=dev) / k ** 0.5
    aab, bab = s2fp8.compute_stats(a), s2fp8.compute_stats(b)
    qa, qb = s2fp8_quant.quant_apply(a, aab), s2fp8_quant.quant_apply(b, bab)
    da = s2fp8.dequantize(s2fp8.S2FP8Tensor(qa, aab))
    db = s2fp8.dequantize(s2fp8.S2FP8Tensor(qb, bab))
    lhs = da.t() if layout == "tn" else da
    rhs = db.t() if layout == "nt" else db
    return qa, aab, qb, bab, lhs.abs() @ rhs.abs()


@pytest.mark.parametrize("layout", ["nn", "nt"])
@pytest.mark.parametrize("m", [8, 16, 17, 63, 64, 65])
def test_gemm_kernel_paths(dev, layout, m):
    """Both paths and both block heights at the planner's edges: M <= 16
    takes the small path (K = 300 split 19 ways), 17-64 the 64-row large
    blocks, 65 the 128-row ones.  K is not a multiple of the 32-deep
    stages nor of 16 bytes (rows padded by the wrapper), N is ragged."""
    k, n = 300, 200
    qa, aab, qb, bab, scale = _gemm_operands(dev, layout, m, k, n, 8)
    plan = s2fp8_matmul.plan_gemm(m, n, k, layout=layout)
    assert plan.path == ("small" if m <= 16 else "large")
    assert plan.path == "large" or plan.splits > 1
    kernel = getattr(s2fp8_matmul, f"qmatmul_{layout}")
    plain = (s2fp8_matmul.qmatmul_plain if layout == "nn"
             else s2fp8_matmul.qmatmul_nt_plain)
    raw_k, raw_p = kernel(qa, aab, qb, bab), plain(qa, aab, qb, bab)
    assert bool(((raw_k - raw_p).abs() <= 1e-5 * scale + 1e-30).all())
    oab = s2fp8.compute_stats(raw_p)
    d = _steps(kernel(qa, aab, qb, bab, oab), plain(qa, aab, qb, bab, oab),
               oab)
    assert d.max() <= 1 and (d != 0).float().mean() <= 1e-3
    assert kernel.launches == 2
    assert kernel.small_launches == (2 if m <= 16 else 0)


def test_gemm_tn_odd_row_stride(dev):
    """TN with A stored [K, M] at an odd row stride (M = 1001 bytes, as the
    vocabulary's 122,753), K not a multiple of the stage depth."""
    m, k, n = 1001, 100, 130
    qa, aab, qb, bab, scale = _gemm_operands(dev, "tn", m, k, n, 9)
    raw_k = s2fp8_matmul.qmatmul_tn(qa, aab, qb, bab)
    raw_p = s2fp8_matmul.qmatmul_tn_plain(qa, aab, qb, bab)
    assert bool(((raw_k - raw_p).abs() <= 1e-5 * scale + 1e-30).all())
    assert kernels.counts()["qmatmul_tn"] == {"launches": 1,
                                              "plain_calls": 1}


def test_gemm_kernels_are_deterministic(dev):
    """Two launches on the same inputs give the same bits on every path:
    large (NN, 128-row blocks), small with a split K (NN, S = 12), the small
    NT head form (S = 1) and batched with a group sum."""
    cases = [("nn", 300, 1000, 260), ("nn", 8, 2304, 5760),
             ("nt", 8, 512, 40000)]
    for layout, m, k, n in cases:
        qa, aab, qb, bab, _ = _gemm_operands(dev, layout, m, k, n, 10)
        kernel = getattr(s2fp8_matmul, f"qmatmul_{layout}")
        oab = s2fp8.compute_stats(kernel(qa, aab, qb, bab))
        assert torch.equal(kernel(qa, aab, qb, bab),
                           kernel(qa, aab, qb, bab))
        assert torch.equal(kernel(qa, aab, qb, bab, oab),
                           kernel(qa, aab, qb, bab, oab))
    gen = torch.Generator(device=dev).manual_seed(11)
    a = torch.randn(8, 300, 64, generator=gen, device=dev)
    b = torch.randn(8, 300, 96, generator=gen, device=dev)
    qa, qb = (s2fp8_quant.quant_apply(x, s2fp8.compute_stats(x))
              for x in (a, b))
    aab, bab = s2fp8.compute_stats(a), s2fp8.compute_stats(b)
    kw = dict(layout="tn", out_batch=2)
    assert torch.equal(s2fp8_matmul.qmatmul_batched(qa, aab, qb, bab, **kw),
                       s2fp8_matmul.qmatmul_batched(qa, aab, qb, bab, **kw))
    assert s2fp8_matmul.qmatmul_nn.small_launches == 5
    assert s2fp8_matmul.qmatmul_nt.small_launches == 5
    assert kernels.counts()["qmatmul_batched"]["launches"] == 2


def _abs_payload(p):
    """The payload of |x|: the sign bit cleared."""
    return (p.view(torch.uint8) & 0x7F).view(p.dtype)


@pytest.mark.parametrize("g", [1, 2])
def test_qflash_fwd_bwd_kernels_head_dim_128(dev, g):
    """d = 128 (DeepSeekMoE's heads): the largest tiles in shared memory
    (the dq and dk/dv kernels need the opt-in above 48 KB)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    bkv, s, d = 4, 300, 128
    q = torch.randn(bkv * g, s, d, generator=gen, device=dev)
    k = torch.randn(bkv, s, d, generator=gen, device=dev)
    v = torch.randn(bkv, s, d, generator=gen, device=dev)
    dout = torch.randn(bkv * g, s, d, generator=gen, device=dev) * 1e-3
    sts = [s2fp8.compute_stats(t) for t in (q, k, v, dout)]
    pq, pk, pv, pg = (s2fp8_quant.quant_apply(t, ab)
                      for t, ab in zip((q, k, v, dout), sts))
    raw, lse = flash_attention.qflash_fwd_plain(pq, pk, pv, *sts[:3], g=g)
    oab = s2fp8.compute_stats(raw)
    ok, lk = flash_attention.qflash_fwd(pq, pk, pv, *sts[:3], g=g,
                                        out_ab=oab)
    op, lp = flash_attention.qflash_fwd_plain(pq, pk, pv, *sts[:3], g=g,
                                              out_ab=oab)
    dd = _steps(ok, op, oab)
    assert dd.max() <= 1 and (dd != 0).float().mean() <= 1e-2
    assert (lk - lp).abs().max() <= 1e-4
    po = s2fp8_quant.quant_apply(raw, oab)
    delta = (s2fp8.dequantize(s2fp8.S2FP8Tensor(pg, sts[3]))
             * s2fp8.dequantize(s2fp8.S2FP8Tensor(po, oab))).sum(-1)
    args = (pq, pk, pv, pg, *sts, lse, delta)
    got = flash_attention.qflash_bwd(*args, g=g)
    want = flash_attention.qflash_bwd_plain(*args, g=g)
    for x, y in zip(got, want):
        assert bool(torch.isfinite(x).all())
        assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item()


def _ulps(a, b):
    """Distance in units of the last place between two f32 tensors of the
    same signs."""
    return (a.float().view(torch.int32).long()
            - b.float().view(torch.int32).long()).abs()


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1000, 333), (3000, 4096), (7,), (0,)])
def test_stats_quant_truncate_fused_kernels(dev, fmt, dtype, shape):
    """The stats kernel, quantize-with-stats and the fused truncate against
    their plain versions: max and count equal, sum within 1e-6 relative,
    (alpha, beta) within 4 ulp, payload and truncated codes at most one
    step apart in at most 1e-4 of the elements; and against each other bit
    for bit (quant = quant_apply with the stats kernel's (alpha, beta),
    truncate_fused = truncate_apply with them), on every run."""
    gen = torch.Generator(device=dev).manual_seed(9)
    x = (torch.randn(shape, generator=gen, device=dev) * 1e-3).to(dtype)
    target = s2fp8.FMT_TARGET_MAX[fmt]
    tk, abk = s2fp8_quant.stats_partials(x, target)
    tp, abp = s2fp8_quant.stats_partials_plain(x, target)
    assert torch.equal(tk[1:], tp[1:])
    assert (tk[0] - tp[0]).abs() <= 1e-6 * tp[0].abs()
    assert _ulps(abk, abp).max() <= 4
    tk2, abk2 = s2fp8_quant.stats_partials(x, target)
    assert torch.equal(tk, tk2) and torch.equal(abk, abk2)

    pk, qab = s2fp8_quant.quant(x, fmt)
    assert torch.equal(qab, abk)
    assert torch.equal(pk.view(torch.uint8),
                       s2fp8_quant.quant_apply(x, abk, fmt).view(torch.uint8))
    pp, _ = s2fp8_quant.quant_plain(x, fmt)
    d = (_ordinal(pk) - _ordinal(pp)).abs()
    assert d.numel() == 0 or (d.max() <= 1 and (d != 0).float().mean() <= 1e-4)

    ok, oab = s2fp8_quant.truncate_fused(x, fmt)
    assert ok.dtype == dtype and torch.equal(oab, abk)
    assert torch.equal(ok, s2fp8_quant.truncate_apply(x, abk, fmt))
    op, _ = s2fp8_quant.truncate_fused_plain(x, fmt)
    d = _steps(ok, op, abk, fmt)
    assert d.numel() == 0 or (d.max() <= 1 and (d != 0).float().mean() <= 1e-4)
    c = kernels.counts()
    assert c["stats"]["launches"] == 2 and c["quant"]["launches"] == 1
    assert c["truncate_fused"]["launches"] == 1


def test_stats_kernels_degenerate_inputs(dev):
    """All zeros -> (1, 0) and zeros back; a constant comes back unchanged;
    NaNs are left out of the stats and truncate to zero, as in the plain
    versions."""
    z = torch.zeros(4096, 33, device=dev)
    tk, ab = s2fp8_quant.stats_partials(z)
    assert tk.tolist() == [0.0, float("-inf"), 0.0] and ab.tolist() == [1, 0]
    out, ab = s2fp8_quant.truncate_fused(z)
    assert ab.tolist() == [1.0, 0.0] and not out.any()
    c = torch.full((300, 77), 2.75, device=dev)
    out, ab = s2fp8_quant.truncate_fused(c)
    assert torch.equal(ab, s2fp8_quant.truncate_fused_plain(c)[1])
    assert (out - 2.75).abs().max() <= 2.75e-2
    x = torch.randn(513, 129, device=dev)
    x[::3, ::5] = float("nan")
    tk, abk = s2fp8_quant.stats_partials(x)
    tz, abz = s2fp8_quant.stats_partials(torch.nan_to_num(x, nan=0.0))
    assert torch.equal(tk, tz) and torch.equal(abk, abz)
    out, _ = s2fp8_quant.truncate_fused(x)
    want, _ = s2fp8_quant.truncate_fused_plain(x)
    assert not out.isnan().any()
    d = _steps(out, want, abk)
    assert d.max() <= 1 and (d != 0).float().mean() <= 1e-4


@pytest.mark.parametrize("b,s,di,n,offset", [
    (2, 100, 300, 16, 0), (1, 64, 128, 8, 0), (3, 7, 33, 1, 0),
    (8, 128, 8192, 16, 0), (2, 37, 136, 5, 0), (2, 37, 136, 16, 1),
    (1, 50, 100, 5, 0)])
def test_selective_scan_kernel(dev, b, s, di, n, offset):
    """Serve-mamba's smallest prefill (8 x 128 x 8192 x 16), n = 5, di not
    a multiple of a block's 64 channels (and 33 and 100 not of 4: the
    4-byte path), S not a multiple of the 16-step chunk, and x, dt 4 bytes
    off a 16-byte boundary (``offset``, also the 4-byte path); two
    launches give the same bits."""
    g = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def shifted(t):   # the same values, ``offset`` floats past an aligned
        buf = t.new_empty(offset + t.numel())      # allocation
        buf[offset:] = t.flatten()
        return buf[offset:].view(t.shape)

    args = (shifted(rnd(b, s, di, scale=0.5)),
            shifted(torch.nn.functional.softplus(rnd(b, s, di) - 1.0)),
            rnd(b, s, n, scale=0.5), rnd(b, s, n, scale=0.5),
            -torch.exp(rnd(di, n, scale=0.3)), rnd(di))
    assert all(t.data_ptr() % 16 == 4 * offset for t in args[:2])
    yk, hk = selective_scan.selective_scan(*args)
    yp, hp = selective_scan.selective_scan_plain(*args)
    assert yk.shape == (b, s, di) and hk.shape == (b, di, n)
    assert (yk - yp).abs().max() <= 1e-5 * yp.abs().max()
    assert (hk - hp).abs().max() <= 1e-5 * hp.abs().max()
    assert kernels.counts()["selective_scan"]["launches"] == 1
    yk2, hk2 = selective_scan.selective_scan(*args)
    assert torch.equal(yk, yk2) and torch.equal(hk, hk2)
    with pytest.raises(ValueError, match="states"):
        selective_scan.selective_scan(*args[:2], rnd(b, s, 65), rnd(b, s, 65),
                                      rnd(di, 65), args[5])


def _scan_args(dev, seed, b, s, di, n, nh):
    """Seeded scan inputs on the card: per channel (nh 0) or per head."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    width = nh or di
    x = rnd(b, s, di, scale=0.5)
    dt = torch.nn.functional.softplus(rnd(b, s, width) - 1.0)
    a = -torch.exp(rnd(nh, scale=0.3) if nh else rnd(di, n, scale=0.3))
    return (x, dt, rnd(b, s, n, scale=0.5), rnd(b, s, n, scale=0.5), a,
            rnd(width)), rnd(b, s, di)


SCAN_WIDE = [(2, 37, 136, 40, 0), (1, 50, 100, 64, 0), (2, 37, 256, 8, 8),
             (2, 37, 96, 64, 3), (2, 40, 128, 64, 16), (8, 128, 4096, 64, 64)]


@pytest.mark.parametrize("b,s,di,n,nh", SCAN_WIDE)
def test_selective_scan_kernel_wide_and_per_head(dev, b, s, di, n, nh):
    """The widened scan (16 lanes a channel above 16 states) per channel
    and per head (one dt, A and D a head: the reduced zamba2's 8 heads of
    32 with 8 states, heads of 32, 8 and 64 channels with 64 states, and
    serve-zamba2's smallest prefill, 8 x 128 x 64 heads of 64, 64 states):
    y and the final h within 1e-5 * max |plain|, h bit for bit, the chunk
    states the plain replay's, and the same bits on a second launch."""
    args, _ = _scan_args(dev, 7, b, s, di, n, nh)
    yk, hk, ck = selective_scan.selective_scan(*args, chunk_states=True)
    yp, hp = selective_scan.selective_scan_plain(*args)
    assert (yk - yp).abs().max() <= 1e-5 * yp.abs().max()
    assert torch.equal(hk, hp)
    assert ck.shape == (b, -(-s // 16), di, n) and not ck[:, 0].any()
    _, h16 = selective_scan.selective_scan_plain(
        *(t[:, :16] if t.dim() == 3 else t for t in args))
    assert torch.equal(ck[:, 1], h16)
    yk2, hk2 = selective_scan.selective_scan(*args)
    assert torch.equal(yk, yk2) and torch.equal(hk, hk2)
    assert kernels.counts()["selective_scan"]["launches"] == 2


SCAN_BWD = [(2, 37, 136, 5, 0), (2, 37, 100, 16, 0), (1, 50, 96, 64, 0),
            (2, 37, 256, 8, 8), (2, 37, 256, 64, 4), (2, 37, 96, 64, 3),
            (2, 40, 128, 64, 16), (4, 64, 8192, 16, 0), (4, 64, 4096, 64, 64)]


@pytest.mark.parametrize("b,s,di,n,nh", SCAN_BWD)
def test_selective_scan_bwd_kernel(dev, b, s, di, n, nh):
    """The scan's backward kernel against autograd through the plain
    version: each of dx, ddt, dB, dC, dA, dD within 1e-4 * max |plain|
    (the same terms summed in another order: the channel sums in a
    block's order, then the blocks' partials by index; measured under
    1e-6), and the same bits on a second launch (fixed orders, no float
    atomics).  Per channel at 5, 16 and 64 states, per head with heads of
    32 (two a block), 64 (over four blocks), 32 and 8 channels, and
    falcon's and zamba2's widths over 64 steps."""
    args, dy = _scan_args(dev, 9, b, s, di, n, nh)
    _, _, ck = selective_scan.selective_scan(*args, chunk_states=True)
    gk = selective_scan.selective_scan_bwd(*args, dy, ck)
    gp = selective_scan.selective_scan_bwd_plain(*args, dy)
    for name, k, p in zip(("dx", "ddt", "dB", "dC", "dA", "dD"), gk, gp):
        assert k.shape == p.shape, name
        assert (k - p).abs().max() <= 1e-4 * p.abs().max(), name
    again = selective_scan.selective_scan_bwd(*args, dy, ck)
    assert all(torch.equal(u, v) for u, v in zip(gk, again))
    assert kernels.counts()["selective_scan_bwd"]["launches"] == 2


def test_selective_scan_fn_routes_through_both_kernels(dev):
    """``SelectiveScanFn`` on CUDA tensors launches the forward (with
    chunk states) and the backward kernel once each, and its gradients are
    the backward kernel's."""
    args, dy = _scan_args(dev, 11, 2, 40, 128, 64, 4)
    ins = [t.clone().requires_grad_(True) for t in args]
    y = selective_scan.SelectiveScanFn.apply(*ins)
    grads = torch.autograd.grad(y, ins, dy)
    assert kernels.counts()["selective_scan"]["launches"] == 1
    assert kernels.counts()["selective_scan_bwd"]["launches"] == 1
    gp = selective_scan.selective_scan_bwd_plain(*args, dy)
    for k, p in zip(grads, gp):
        assert (k - p).abs().max() <= 1e-4 * p.abs().max()


def test_selective_scan_bwd_refuses(dev):
    """A head dim that neither divides a block's channels nor is a
    multiple of them (24 at 64 states: blocks of 16), and chunk states of
    the wrong shape."""
    args, dy = _scan_args(dev, 13, 1, 20, 48, 64, 2)
    _, _, ck = selective_scan.selective_scan(*args, chunk_states=True)
    with pytest.raises(ValueError, match="head dim"):
        selective_scan.selective_scan_bwd(*args, dy, ck)
    args, dy = _scan_args(dev, 13, 1, 20, 64, 8, 0)
    with pytest.raises(ValueError, match="chunk states"):
        selective_scan.selective_scan_bwd(*args, dy, ck)
    assert kernels.counts()["selective_scan_bwd"]["launches"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,sq,sk,d", [
    (True, None, 200, 200, 64), (True, 64, 100, 300, 128),
    (False, None, 130, 70, 32), (True, 30, 64, 64, 80),
    (True, None, 100, 60, 64)])
def test_flash_fwd_kernel(dev, dtype, causal, window, sq, sk, d):
    """The last case has Sq > Sk: its first 40 query rows see no key."""
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn(2, 3, sq, d, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 3, sk, d, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 3, sk, d, generator=g, device=dev).to(dtype)
    ok = flash_attention.flash_attention(q, k, v, causal=causal,
                                         window=window)
    op = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                               window=window)
    assert ok.dtype == dtype and ok.shape == q.shape
    rtol, atol = (2e-4, 2e-5) if dtype == torch.float32 else (1e-2, 1e-3)
    torch.testing.assert_close(ok.float(), op.float(), rtol=rtol, atol=atol)
    if sq > sk and causal:
        assert not ok[:, :, :sq - sk].any() and not op[:, :, :sq - sk].any()
    assert kernels.counts()["flash_fwd"]["launches"] == 1


def test_flash_fwd_kernel_refuses(dev):
    q = torch.randn(1, 2, 8, 264, device=dev)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention.flash_attention(q, q, q)
    q = torch.randn(1, 2, 8, 64, device=dev)
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q, q.bfloat16(), q)
    assert kernels.counts()["flash_fwd"]["launches"] == 0


def _qflash_inputs(dev, seed, bkv, g, sq, sk, d, fmt="e5m2"):
    """Seeded payload Q/K/V and output cotangent, their stats, and the
    backward's residuals (lse and delta) from the plain forward."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(bkv * g, sq, d, generator=gen, device=dev)
    k = torch.randn(bkv, sk, d, generator=gen, device=dev)
    v = torch.randn(bkv, sk, d, generator=gen, device=dev)
    dout = torch.randn(bkv * g, sq, d, generator=gen, device=dev) * 1e-3
    sts = [s2fp8.compute_stats(t, s2fp8.FMT_TARGET_MAX[fmt])
           for t in (q, k, v, dout)]
    pq, pk, pv, pg = (s2fp8_quant.quant_apply(t, ab, fmt)
                      for t, ab in zip((q, k, v, dout), sts))
    return pq, pk, pv, pg, sts


def _delta(pg, gab, out, oab, fmt):
    po = s2fp8_quant.quant_apply(out, oab, fmt)
    return (s2fp8.dequantize(s2fp8.S2FP8Tensor(pg, gab, fmt))
            * s2fp8.dequantize(s2fp8.S2FP8Tensor(po, oab, fmt))).sum(-1)


@pytest.mark.parametrize("d,sq,sk,causal,window,fmt", [
    (1, 37, 37, True, None, "e5m2"),       # d = 1: one byte a row
    (8, 1, 70, True, None, "e5m2"),        # one query row at the end
    (72, 100, 100, True, 40, "e4m3"),      # d padded to 80; a window
    (64, 77, 200, True, None, "e5m2"),     # Sq < Sk, END-aligned
    (32, 200, 77, True, None, "e5m2"),     # Sq > Sk: rows that see no key
    (72, 130, 129, False, None, "e5m2"),   # not causal, ragged both ways
])
def test_qflash_kernels_tile_edges(dev, d, sq, sk, causal, window, fmt):
    """Head dims 1, 8 and 72, one query row, Sq not a multiple of 16 or
    64, Sq != Sk under END alignment: the payload forward (output codes,
    lse) and backward against their plain versions; a query row that sees
    no key gives 0 on both sides, forward and dq."""
    pq, pk, pv, pg, sts = _qflash_inputs(dev, 9, 3, 2, sq, sk, d, fmt)
    kw = dict(g=2, causal=causal, window=window)
    raw, lse = flash_attention.qflash_fwd_plain(pq, pk, pv, *sts[:3],
                                                fmt=fmt, **kw)
    oab = s2fp8.compute_stats(raw, s2fp8.FMT_TARGET_MAX[fmt])
    ok, lk = flash_attention.qflash_fwd(pq, pk, pv, *sts[:3], out_ab=oab,
                                        fmt=fmt, **kw)
    op, lp = flash_attention.qflash_fwd_plain(pq, pk, pv, *sts[:3],
                                              out_ab=oab, fmt=fmt, **kw)
    dd = _steps(ok, op, oab, fmt)
    assert dd.max() <= 1 and (dd != 0).float().mean() <= 1e-2
    assert (lk - lp).abs().max() <= 1e-4
    args = (pq, pk, pv, pg, *sts, lse, _delta(pg, sts[3], raw, oab, fmt))
    got = flash_attention.qflash_bwd(*args, **kw)
    want = flash_attention.qflash_bwd_plain(*args, **kw)
    for x, y in zip(got, want):
        assert bool(torch.isfinite(x).all())
        assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item()
    blind = max(sq - sk, 0) if causal else 0
    if blind:
        assert not ok[:, :blind].any() and not op[:, :blind].any()
        assert not got[0][:, :blind].any() and not want[0][:, :blind].any()
    assert kernels.counts()["qflash_fwd"]["launches"] == 1
    assert kernels.counts()["qflash_bwd"]["launches"] == 1


@pytest.mark.parametrize("d,sq,sk", [(8, 1, 70), (72, 130, 129),
                                     (128, 300, 300)])
def test_flash_fwd_kernel_tile_edges(dev, d, sq, sk):
    """The plain forward at d = 8 and 72 with one query row or a ragged
    Sq != Sk, f32 and bf16 from the same values."""
    gen = torch.Generator(device=dev).manual_seed(10)
    q = torch.randn(1, 4, sq, d, generator=gen, device=dev)
    k = torch.randn(1, 4, sk, d, generator=gen, device=dev)
    v = torch.randn(1, 4, sk, d, generator=gen, device=dev)
    for dtype, rtol, atol in ((torch.float32, 2e-4, 2e-5),
                              (torch.bfloat16, 1e-2, 1e-3)):
        t = [x.to(dtype) for x in (q, k, v)]
        ok = flash_attention.flash_attention(*t, window=50)
        op = flash_attention.flash_attention_plain(*t, window=50)
        torch.testing.assert_close(ok.float(), op.float(), rtol=rtol,
                                   atol=atol)
    assert kernels.counts()["flash_fwd"]["launches"] == 2


@pytest.mark.parametrize("g,window", [(2, 100), (4, None)])
def test_qflash_bwd_kernel_head_dim_128_gqa(dev, g, window):
    """The backward at d = 128 with grouped K/V heads, windowed or not:
    per-head dk / dv against the plain version."""
    pq, pk, pv, pg, sts = _qflash_inputs(dev, 11, 2, g, 300, 300, 128)
    raw, lse = flash_attention.qflash_fwd_plain(pq, pk, pv, *sts[:3], g=g,
                                                window=window)
    oab = s2fp8.compute_stats(raw)
    args = (pq, pk, pv, pg, *sts, lse, _delta(pg, sts[3], raw, oab, "e5m2"))
    got = flash_attention.qflash_bwd(*args, g=g, window=window)
    want = flash_attention.qflash_bwd_plain(*args, g=g, window=window)
    for x, y in zip(got, want):
        assert x.shape == y.shape
        assert bool(torch.isfinite(x).all())
        assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item()


def test_flash_kernels_are_deterministic(dev):
    """Two launches on the same inputs give the same bits: the payload
    forward (output, lse), the backward (dq, dk, dv; no float atomics) and
    the plain forward in f32 and bf16."""
    pq, pk, pv, pg, sts = _qflash_inputs(dev, 12, 2, 2, 333, 333, 64)
    kw = dict(g=2, window=200)
    raw, lse = flash_attention.qflash_fwd_plain(pq, pk, pv, *sts[:3], **kw)
    oab = s2fp8.compute_stats(raw)
    first = flash_attention.qflash_fwd(pq, pk, pv, *sts[:3], out_ab=oab, **kw)
    second = flash_attention.qflash_fwd(pq, pk, pv, *sts[:3], out_ab=oab,
                                        **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    args = (pq, pk, pv, pg, *sts, lse, _delta(pg, sts[3], raw, oab, "e5m2"))
    first = flash_attention.qflash_bwd(*args, **kw)
    second = flash_attention.qflash_bwd(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v = (torch.randn(2, 3, 257, 128, generator=gen, device=dev)
               for _ in range(3))
    for dtype in (torch.float32, torch.bfloat16):
        t = [x.to(dtype) for x in (q, k, v)]
        assert torch.equal(flash_attention.flash_attention(*t),
                           flash_attention.flash_attention(*t))


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_code_table_matches_direct_map_everywhere(dev, fmt):
    """The code table's byte equals the direct map's (to_fp8 of +-exp2f(t))
    for every one of the 2^32 f32 bit patterns t, both signs: 0
    mismatches, so quantize-apply and the fused truncate may encode by
    the table."""
    bad, first = s2fp8_quant.code_sweep(dev, fmt)
    assert bad == 0, f"{bad} mismatches, the least at t bits {first:#010x}"


# ragged sizes: every edge of the vector split (1, 7, a vector of f32 or
# bf16 and one either side), the fused kernels' capacity in x's dtype and
# one either side (("cap", d): read per card inside the test), the empty
# tensor, and 20 M elements (80 MB in f32, 40 MB in bf16 plus the output:
# past the 50 MB L2)
EDGE_SIZES = [0, 1, 3, 4, 5, 7, 8, 9, ("cap", -1), ("cap", 0), ("cap", 1),
              20_000_000]


def _edge_input(dev, size, dtype, offset):
    n = (s2fp8_quant.fused_capacity(dev, dtype) + size[1]
         if isinstance(size, tuple) else size)
    gen = torch.Generator(device=dev).manual_seed(n % 1000 + offset)
    x = torch.randn(n + offset, generator=gen, device=dev).to(dtype)
    x[::97] = 0.0
    return x[offset:]             # offset 1: not on a 16-byte boundary


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("size", EDGE_SIZES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_quant_apply_and_fused_truncate_edges(dev, fmt, dtype, size, offset):
    """Quantize-apply and the fused truncate at the edges of their element
    maps: codes within the quantize tolerance of the plain version and, bit
    for bit, the codes whose dequantized values truncate-apply gives (the
    same encode, Eq. 5 as lut[code]); the fused truncate bit for bit
    truncate_apply(x, stats(x)) with the stats kernel's (alpha, beta); two
    launches of each give the same bits."""
    x = _edge_input(dev, size, dtype, offset)
    target = s2fp8.FMT_TARGET_MAX[fmt]
    _, abk = s2fp8_quant.stats_partials(x, target)
    pk = s2fp8_quant.quant_apply(x, abk, fmt)
    assert pk.shape == x.shape and pk.dtype == s2fp8.FMT_QDTYPE[fmt]
    assert torch.equal(pk.view(torch.uint8),
                       s2fp8_quant.quant_apply(x, abk, fmt).view(torch.uint8))
    pp = s2fp8_quant.quant_apply_plain(x, abk, fmt)
    d = (_ordinal(pk) - _ordinal(pp)).abs()
    assert d.numel() == 0 or (d.max() <= 1 and (d != 0).float().mean() <= 1e-4)
    assert torch.equal(s2fp8_quant.dequant(pk, abk),
                       s2fp8_quant.truncate_apply(x.float(), abk, fmt))

    ok, oab = s2fp8_quant.truncate_fused(x, fmt)
    assert ok.dtype == dtype and ok.shape == x.shape
    assert torch.equal(oab, abk)
    assert torch.equal(ok, s2fp8_quant.truncate_apply(x, abk, fmt))
    ok2, oab2 = s2fp8_quant.truncate_fused(x, fmt)
    assert torch.equal(ok, ok2) and torch.equal(oab, oab2)
    c = kernels.counts()
    assert c["quant_apply"]["launches"] == 2
    assert c["truncate_fused"]["launches"] == 2


def _near_thresholds(thr, fmt, alpha, beta, ulps=48):
    """f32 x of both signs whose t = alpha log2|x| + beta lies within a few
    ulp of every code threshold of ``fmt``: the inputs where a bucket or
    threshold of the code table off by one would show."""
    m = {"e5m2": 0x7B, "e4m3": 0x7E}[fmt]
    t = thr[1:m + 1].double().cpu()
    x = torch.exp2((t - beta) / alpha).float()
    bits = x.view(torch.int32)[:, None] + torch.arange(
        -ulps, ulps + 1, dtype=torch.int32)
    x = bits.flatten().view(torch.float32)
    return torch.cat([x, -x])


@pytest.mark.parametrize("ab", [(1.0, 15.0), (0.37, 2.1), (2.5, -7.25)],
                         ids=str)
@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_quant_apply_near_code_thresholds(dev, fmt, ab):
    """Inputs within 48 ulp of every code threshold: quantize-apply's
    codes are the plain version's (torch's log2, exp2 and cast on the
    card), and truncate-apply's values their decoded values, bit for bit.
    The decoded values ascend with the code, so equal values mean equal
    codes."""
    alpha, beta = ab
    m = {"e5m2": 0x7B, "e4m3": 0x7E}[fmt]
    thr = s2fp8_quant.code_thresholds(dev, fmt)
    assert bool((thr[2:m + 1] > thr[1:m]).all())
    x = _near_thresholds(thr, fmt, alpha, beta).to(dev)
    abt = torch.tensor([alpha, beta], device=dev)
    pk = s2fp8_quant.quant_apply(x, abt, fmt)
    assert torch.equal(pk.view(torch.uint8), s2fp8_quant.quant_apply_plain(
        x, abt, fmt).view(torch.uint8))
    codes = torch.arange(128, dtype=torch.uint8, device=dev)
    lut = s2fp8_quant.dequant(codes.view(s2fp8.FMT_QDTYPE[fmt]), abt)
    assert bool((lut[1:m + 1] > lut[:m]).all())
    assert torch.equal(s2fp8_quant.dequant(pk, abt),
                       s2fp8_quant.truncate_apply(x, abt, fmt))
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        assert torch.equal(s2fp8_quant.dequant(
            s2fp8_quant.quant_apply(xd, abt, fmt), abt),
            s2fp8_quant.truncate_apply(xd.float(), abt, fmt))


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_fused_truncate_near_code_thresholds(dev, fmt):
    """A tensor past the fused truncate's register capacity whose last
    elements (re-read in phase 1 and encoded there) lie within a
    few ulp of the code thresholds under the tensor's own stats:
    truncate_fused(x) is truncate_apply(x, stats(x)) bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(31)
    n = 2 * s2fp8_quant.fused_capacity(dev)
    x = torch.randn(n, generator=gen, device=dev)
    target = s2fp8.FMT_TARGET_MAX[fmt]
    thr = s2fp8_quant.code_thresholds(dev, fmt)
    for _ in range(2):   # the tail moves the stats by ulps only
        _, ab = s2fp8_quant.stats_partials(x, target)
        tail = _near_thresholds(thr, fmt, float(ab[0]), float(ab[1]), 8)
        tail = tail[torch.isfinite(tail) & (tail != 0)].to(dev)
        x[-tail.numel():] = tail
    _, ab = s2fp8_quant.stats_partials(x, target)
    out, oab = s2fp8_quant.truncate_fused(x, fmt)
    assert torch.equal(oab, ab)
    assert torch.equal(out, s2fp8_quant.truncate_apply(x, ab, fmt))


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


# ragged sizes around truncate-apply's 16-byte vectors, and 20 M elements
# (several rounds of its one-wave grid)
TRUNC_SIZES = [1, 3, 7, 8, 9, 4099, 1_000_003, 20_000_003]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("size", TRUNC_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_truncate_apply_is_dequant_of_quant_apply(dev, fmt, dtype, size,
                                                  offset):
    """Truncate-apply (code-table encode, Eq. 5 as lut[code] in x's dtype)
    equals dequant(quant_apply(x)) rounded to x's dtype bit for bit, on
    ragged sizes and on a view one element past a 16-byte boundary
    (``x.view(-1)[1:]``); it stays within the truncate tolerance of the
    plain version, and two launches give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(size % 1000 + offset)
    x = (torch.randn(size + offset, generator=gen, device=dev) * torch.exp2(
        torch.rand(size + offset, generator=gen, device=dev) * 40 - 20)
         ).to(dtype)
    x[::97] = 0.0
    x = x.view(-1)[offset:]
    ab = s2fp8.compute_stats(x, s2fp8.FMT_TARGET_MAX[fmt])
    tk = s2fp8_quant.truncate_apply(x, ab, fmt)
    assert tk.dtype == dtype and tk.shape == x.shape
    want = s2fp8_quant.dequant(s2fp8_quant.quant_apply(x, ab, fmt), ab)
    assert torch.equal(_bits(tk), _bits(want.to(dtype)))
    assert torch.equal(_bits(tk), _bits(s2fp8_quant.truncate_apply(x, ab,
                                                                   fmt)))
    d = _steps(tk, s2fp8_quant.truncate_apply_plain(x, ab, fmt), ab, fmt)
    assert d.max() <= 1 and (d != 0).float().mean() <= 1e-4
    assert kernels.counts()["truncate_apply"]["launches"] == 2


def _paged_case(dev, fmt, b, kvh, g, hd, blk, max_b, seed):
    """Seeded q, K / V pools quantized at their own stats, and a table of
    distinct live blocks per slot (block 0, the trash block, unused)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb = b * max_b + 1
    q = torch.randn(b, kvh, g, hd, generator=gen, device=dev)
    kf = torch.randn(nb, kvh, blk, hd, generator=gen, device=dev)
    vf = torch.randn(nb, kvh, blk, hd, generator=gen, device=dev)
    kab = s2fp8.compute_stats(kf, s2fp8.FMT_TARGET_MAX[fmt])
    vab = s2fp8.compute_stats(vf, s2fp8.FMT_TARGET_MAX[fmt])
    kp = s2fp8_quant.quant_apply(kf, kab, fmt)
    vp = s2fp8_quant.quant_apply(vf, vab, fmt)
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    table = perm.reshape(b, max_b).to(torch.int32)
    return q, kp, vp, kab, vab, table


def _paged_check(q, kp, vp, kab, vab, table, pos, fmt):
    """The kernel against the plain version (|kernel - plain| <= 1e-4 *
    |plain| + 1e-5), finite, and the same bits on a second launch."""
    ok = paged_attention.paged_decode_attention(q, kp, vp, kab, vab, table,
                                                pos, fmt)
    op = paged_attention.paged_decode_plain(q, kp, vp, kab, vab, table, pos,
                                            fmt)
    assert torch.isfinite(ok).all()
    err = (ok - op).abs()
    assert bool((err <= 1e-4 * op.abs() + 1e-5).all()), err.max().item()
    assert torch.equal(ok, paged_attention.paged_decode_attention(
        q, kp, vp, kab, vab, table, pos, fmt))
    return ok, op


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_paged_kernel_serve_shape_split_edges(dev, fmt):
    """Serve's shape (8 slots x 36 KV heads, hd 64, block 16, 64 blocks a
    slot) with positions on both sides of the kernel's split boundaries,
    the first and last block edges and the table's last position."""
    s = paged_attention.SPLIT
    case = _paged_case(dev, fmt, 8, 36, 1, 64, 16, 64, 21)
    pos = torch.tensor([0, 15, 16, s - 1, s, 2 * s - 1, 2 * s + 1, 1023],
                       dtype=torch.int32, device=dev)
    _paged_check(*case, pos, fmt)
    assert kernels.counts()["paged_decode"]["launches"] == 2


@pytest.mark.parametrize("g", [3, 5])
def test_paged_kernel_gqa_head_dim_128(dev, g):
    """G query rows per KV head at hd 128 (G = 5: two row chunks of the
    grid), block 32, split edges and the table's last position."""
    s = paged_attention.SPLIT
    case = _paged_case(dev, "e5m2", 5, 2, g, 128, 32, 3 * s // 32, 22 + g)
    pos = torch.tensor([s - 1, s, 3 * s - 1, 5, 2 * s + 7], dtype=torch.int32,
                       device=dev)
    _paged_check(*case, pos, "e5m2")


@pytest.mark.parametrize("hd,blk", [(64, 16), (32, 8), (128, 32)])
def test_paged_kernel_dead_slots(dev, hd, blk):
    """Dead slots (table rows of trash block 0, position 0) beside live
    ones: each dead slot attends row 0 of block 0 alone, so its output is
    that row's dequantized V, finite."""
    q, kp, vp, kab, vab, table = _paged_case(dev, "e4m3", 4, 3, 2, hd, blk,
                                             16, 23)
    table[1] = 0
    table[3] = 0
    pos = torch.tensor([200, 0, 130, 0], dtype=torch.int32, device=dev)
    ok, _ = _paged_check(q, kp, vp, kab, vab, table, pos, "e4m3")
    trash = s2fp8_quant.dequant(vp[0, :, 0].contiguous(), vab)   # [KV, hd]
    for slot in (1, 3):
        assert torch.allclose(ok[slot], trash[:, None].expand_as(ok[slot]),
                              rtol=1e-6, atol=0)


def test_stats_ticket_resets_across_calls_and_streams(dev):
    """The stats kernel's and the fused kernels' last block sets the
    stream's ticket back to 0: stats, quantize-with-stats and fused
    truncate calls of different sizes and dtypes back to back on one
    stream, then on a second stream, give the bits of fresh calls (each
    with a new ticket), and every ticket is 0 afterwards."""
    gen = torch.Generator(device=dev).manual_seed(41)
    xs = [(torch.randn(n, generator=gen, device=dev) * scale).to(dtype)
          for n, scale, dtype in [
              (1, 1.0, torch.float32), (5000, 3.0, torch.bfloat16),
              (3_000_001, 0.1, torch.float32), (70_001, 1e-3, torch.float32),
              (4096 * 600 + 3, 2.0, torch.bfloat16), (17, 0.5, torch.float32)]]

    def calls(x):
        q, qab = s2fp8_quant.quant(x)
        t, tab = s2fp8_quant.truncate_fused(x)
        return torch.cat([*s2fp8_quant.stats_partials(x), qab, tab,
                          q.view(torch.uint8).float(), t.float()])

    fresh = []
    for x in xs:
        s2fp8_quant._TICKETS.clear()
        fresh.append(calls(x))
        torch.cuda.synchronize()
    got = [calls(x) for x in xs + xs]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got += [calls(x) for x in xs]
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    for i, g in enumerate(got):
        assert torch.equal(g, fresh[i % len(xs)]), i
    assert len(s2fp8_quant._TICKETS) == 2
    assert not any(t.any() for t in s2fp8_quant._TICKETS.values())
    assert kernels.counts()["stats"]["launches"] == 4 * len(xs)


# sizes around the fused kernels' keep: 1, 7 and 9 elements, the register
# capacity and the whole capacity in x's dtype (("reg" / "cap", d), read
# per card inside the test) and one either side, a million past the
# capacity, and 20 M elements (mostly re-read)
FUSED_SIZES = [1, 7, 9, ("reg", -1), ("reg", 1), ("cap", -1), ("cap", 0),
               ("cap", 1), ("cap", 1_000_003), 20_000_000]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("size", FUSED_SIZES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_quant_fused_is_quant_apply_of_stats(dev, fmt, dtype, size, offset):
    """Quantize-with-stats (one cooperative launch) on both sides of what
    it keeps in registers and in shared memory, at unaligned offsets:
    (payload, ab) equal to (quant_apply(x, stats(x)), stats(x)) bit for
    bit, twice the same bits, one launch a call."""
    if isinstance(size, tuple):
        n = s2fp8_quant.fused_capacity(dev, dtype,
                                       registers=size[0] == "reg") + size[1]
    else:
        n = size
    gen = torch.Generator(device=dev).manual_seed(n % 1000 + offset)
    x = (torch.randn(n + offset, generator=gen, device=dev) * torch.exp2(
        torch.rand(n + offset, generator=gen, device=dev) * 30 - 15)
         ).to(dtype)
    x[::97] = 0.0
    x = x[offset:]
    target = s2fp8.FMT_TARGET_MAX[fmt]
    _, abk = s2fp8_quant.stats_partials(x, target)
    pk, qab = s2fp8_quant.quant(x, fmt)
    assert pk.shape == x.shape and pk.dtype == s2fp8.FMT_QDTYPE[fmt]
    assert torch.equal(qab, abk)
    assert torch.equal(pk.view(torch.uint8),
                       s2fp8_quant.quant_apply(x, abk, fmt).view(torch.uint8))
    pk2, qab2 = s2fp8_quant.quant(x, fmt)
    assert torch.equal(pk.view(torch.uint8), pk2.view(torch.uint8))
    assert torch.equal(qab, qab2)
    assert kernels.counts()["quant"]["launches"] == 2


# (layout, M, K, N) of the paper workloads' narrow GEMMs: the ResNet stem's
# K = 27 with its NT dA (N = 27) and TN dW (M = 27); NCF's output GEMM
# (N = 1), its NT dA (K = 1) and TN dW (N = 1); the ResNet head (N = 10)
# with its NT dA (K = 10) and TN dW (N = 10)
PAPER_GEMMS = [("nn", 4096, 27, 16), ("nt", 4096, 16, 27),
               ("tn", 27, 4096, 16),
               ("nn", 1024, 16, 1), ("nt", 1024, 1, 16), ("tn", 16, 1024, 1),
               ("nn", 128, 64, 10), ("nt", 128, 10, 64), ("tn", 64, 128, 10)]


@pytest.mark.parametrize("layout,m,k,n", PAPER_GEMMS)
def test_gemm_kernels_at_paper_widths(dev, layout, m, k, n):
    """K = 27, N = 1 and N = 10 in NN, NT and TN (rows of 27, 1 and 10
    bytes are copied into 16-byte strides): raw output within 1e-5 * (|A|
    @ |B|), epilogue codes at most one step apart in at most 1e-3 of the
    outputs, the same bits on a second launch."""
    g = torch.Generator(device=dev).manual_seed(13)
    a = torch.randn(*((k, m) if layout == "tn" else (m, k)), generator=g,
                    device=dev)
    b = torch.randn(*((n, k) if layout == "nt" else (k, n)), generator=g,
                    device=dev) / k ** 0.5
    aab, bab = s2fp8.compute_stats(a), s2fp8.compute_stats(b)
    qa, qb = s2fp8_quant.quant_apply(a, aab), s2fp8_quant.quant_apply(b, bab)
    kernel = getattr(s2fp8_matmul, f"qmatmul_{layout}")
    plain = (s2fp8_matmul.qmatmul_plain if layout == "nn"
             else getattr(s2fp8_matmul, f"qmatmul_{layout}_plain"))
    da = s2fp8.dequantize(s2fp8.S2FP8Tensor(qa, aab))
    db = s2fp8.dequantize(s2fp8.S2FP8Tensor(qb, bab))
    lhs = da.t() if layout == "tn" else da
    rhs = db.t() if layout == "nt" else db
    raw_k, raw_p = kernel(qa, aab, qb, bab), plain(qa, aab, qb, bab)
    assert raw_k.shape == (m, n)
    assert bool(((raw_k - raw_p).abs() <= 1e-5 * (lhs.abs() @ rhs.abs())
                 + 1e-30).all())
    oab = s2fp8.compute_stats(raw_p)
    ek = kernel(qa, aab, qb, bab, oab)
    d = _steps(ek, plain(qa, aab, qb, bab, oab), oab)
    assert d.max() <= 1 and (d != 0).float().mean() <= 1e-3
    assert torch.equal(kernel(qa, aab, qb, bab, oab), ek)
    assert kernels.counts()[f"qmatmul_{layout}"]["launches"] == 3


@pytest.mark.parametrize("sq", [448, 1])
def test_qflash_kernels_cross_attention(dev, sq):
    """Whisper's cross-attention: non-causal, 448 or 1 query rows over
    1,500 keys, head dim 64, 2 heads: the forward's output codes at most
    one step apart in at most 1e-2 of the elements and |lse| within 1e-4;
    the backward's dq, dk, dv within 1e-4 * max|plain| (448 rows); the
    same bits on a second launch."""
    pq, pk, pv, pg, sts = _qflash_inputs(dev, 17, 2, 1, sq, 1500, 64)
    kw = dict(g=1, causal=False)
    # the plain loop in 500-key chunks (gcd(512, 1500) = 4 otherwise)
    ck = dict(q_chunk=min(sq, 448), kv_chunk=500)
    raw, lse = flash_attention.qflash_fwd_plain(pq, pk, pv, *sts[:3], **kw,
                                                **ck)
    oab = s2fp8.compute_stats(raw)
    ok, lk = flash_attention.qflash_fwd(pq, pk, pv, *sts[:3], out_ab=oab,
                                        **kw)
    op, lp = flash_attention.qflash_fwd_plain(pq, pk, pv, *sts[:3],
                                              out_ab=oab, **kw, **ck)
    dd = _steps(ok, op, oab)
    assert dd.max() <= 1 and (dd != 0).float().mean() <= 1e-2
    assert (lk - lp).abs().max() <= 1e-4
    assert torch.equal(flash_attention.qflash_fwd(
        pq, pk, pv, *sts[:3], out_ab=oab, **kw)[0], ok)
    if sq == 1:
        return
    args = (pq, pk, pv, pg, *sts, lse, _delta(pg, sts[3], raw, oab, "e5m2"))
    got = flash_attention.qflash_bwd(*args, **kw)
    want = flash_attention.qflash_bwd_plain(*args, **kw, **ck)
    for x, y in zip(got, want):
        assert bool(torch.isfinite(x).all())
        assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item()
    again = flash_attention.qflash_bwd(*args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("engine", ["cuda", "cuda_fused"])
def test_checkpoint_codec_kernels(dev, engine, tmp_path):
    """The checkpoint / snapshot codec on the card (``checkpoint.manager``
    ``encode`` / ``decode``): on ``cuda_fused`` quantize-with-stats (#3),
    on ``cuda`` the torch stats and quantize-apply (#2), dequantize (#4)
    on restore; the payload within one code of quantize-apply's plain
    version under the codec's own (alpha, beta) in at most 1e-4 of the
    elements (the math library), the stats within 4 ulp of the plain
    stats; the decoded leaf within 1e-6 relative of the plain
    dequantize of the same payload.  A compressed save and restore through the manager lands
    on the card, the small leaves bit for bit."""
    from repro_torch.checkpoint import manager as ckpt
    g = torch.Generator(device=dev).manual_seed(21)
    w = torch.randn(2304, 576, generator=g, device=dev) * 0.02
    payload, stats = ckpt.encode(w, engine)
    ab = torch.from_numpy(stats).to(dev)
    assert _ulps(ab, s2fp8.compute_stats(w)).max() <= (
        0 if engine == "cuda" else 4)
    pk = torch.from_numpy(payload).to(dev).view(torch.float8_e5m2)
    d = (_ordinal(pk) - _ordinal(s2fp8_quant.quant_apply_plain(
        w, ab, "e5m2"))).abs()
    assert d.max() <= 1 and (d != 0).float().mean() <= 1e-4
    got = ckpt.decode(payload, stats, dev, backend=engine)
    ref = s2fp8_quant.dequant_plain(pk, ab)
    assert got.device.type == "cuda"
    assert bool(((got - ref).abs() <= 1e-6 * ref.abs()).all())
    c = kernels.counts()
    assert c["quant" if engine == "cuda_fused" else "quant_apply"][
        "launches"] == 1
    assert c["dequant"]["launches"] == 1
    tree = {"w": w, "b": torch.randn(576, generator=g, device=dev)}
    m = ckpt.CheckpointManager(str(tmp_path), compress=True, backend=engine)
    m.save(1, tree)
    back, _ = m.restore(tree)
    assert back["w"].device == dev and torch.equal(back["b"], tree["b"])
    assert torch.equal(back["w"], got)
    assert kernels.counts()["dequant"]["launches"] == 2


@pytest.mark.parametrize("d,g,window,sq", [
    (160, 2, None, 300), (192, 4, 100, 257), (256, 4, 512, 700),
    (256, 1, None, 129), (136, 2, 40, 200)])
def test_qflash_kernels_wide_head_dims(dev, d, g, window, sq):
    """Head dims above 128 (each block one of two column chunks of the
    output, dq or dk / dv, the score tiles from the full d): the payload
    forward and backward against their plain versions with the tolerances
    above, and the same bits on a second launch."""
    pq, pk, pv, pg, sts = _qflash_inputs(dev, 14, 2, g, sq, sq, d)
    kw = dict(g=g, window=window)
    raw, lse = flash_attention.qflash_fwd_plain(pq, pk, pv, *sts[:3], **kw)
    oab = s2fp8.compute_stats(raw)
    ok, lk = flash_attention.qflash_fwd(pq, pk, pv, *sts[:3], out_ab=oab,
                                        **kw)
    op, lp = flash_attention.qflash_fwd_plain(pq, pk, pv, *sts[:3],
                                              out_ab=oab, **kw)
    dd = _steps(ok, op, oab)
    assert dd.max() <= 1 and (dd != 0).float().mean() <= 1e-2
    assert (lk - lp).abs().max() <= 1e-4
    again = flash_attention.qflash_fwd(pq, pk, pv, *sts[:3], out_ab=oab,
                                       **kw)
    assert torch.equal(ok, again[0]) and torch.equal(lk, again[1])
    args = (pq, pk, pv, pg, *sts, lse, _delta(pg, sts[3], raw, oab, "e5m2"))
    got = flash_attention.qflash_bwd(*args, **kw)
    want = flash_attention.qflash_bwd_plain(*args, **kw)
    for x, y in zip(got, want):
        assert bool(torch.isfinite(x).all())
        assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item()
    assert all(torch.equal(a, b) for a, b in
               zip(got, flash_attention.qflash_bwd(*args, **kw)))


@pytest.mark.parametrize("d", [160, 192, 256])
def test_flash_fwd_kernel_wide_head_dims(dev, d):
    """The plain forward above d = 128, f32 and bf16, causal with a
    window; the same bits on a second launch."""
    gen = torch.Generator(device=dev).manual_seed(15)
    q, k, v = (torch.randn(1, 4, 300, d, generator=gen, device=dev)
               for _ in range(3))
    for dtype, rtol, atol in ((torch.float32, 2e-4, 2e-5),
                              (torch.bfloat16, 1e-2, 1e-3)):
        t = [x.to(dtype) for x in (q, k, v)]
        ok = flash_attention.flash_attention(*t, window=100)
        op = flash_attention.flash_attention_plain(*t, window=100)
        torch.testing.assert_close(ok.float(), op.float(), rtol=rtol,
                                   atol=atol)
        assert torch.equal(ok, flash_attention.flash_attention(*t,
                                                               window=100))


def test_qflash_kernels_refuse_above_256(dev):
    p = torch.zeros((2, 8, 272), dtype=torch.uint8, device=dev).view(
        torch.float8_e5m2)
    ab = torch.tensor([1.0, 0.0], device=dev)
    with pytest.raises(ValueError, match="head dims 1..256"):
        flash_attention.qflash_fwd(p, p, p, ab, ab, ab, g=1)
    with pytest.raises(ValueError, match="head dims 1..256"):
        flash_attention.qflash_bwd(p, p, p, p, ab, ab, ab, ab,
                                   torch.zeros(2, 8, device=dev),
                                   torch.zeros(2, 8, device=dev), g=1)
    assert kernels.counts()["qflash_fwd"]["launches"] == 0


@pytest.mark.parametrize("hd,g", [(16, 4), (48, 3), (80, 2), (160, 4),
                                  (192, 12), (240, 1), (256, 5)])
def test_paged_decode_kernel_padded_lane_groups(dev, hd, g):
    """Head dims whose hd / 16 lanes are not a power of two (3, 5, 10, 12,
    15 of a padded group) or one lane (hd 16) or 16 (hd 256), G up to 12:
    allclose to the plain version (1e-4 relative + 1e-5), positions on
    both sides of the split, a dead slot, and the same bits twice."""
    gen = torch.Generator(device=dev).manual_seed(hd + g)
    b, kvh, blk, max_b = 6, 2, 16, 40
    nb = b * max_b + 1
    q = torch.randn(b, kvh, g, hd, generator=gen, device=dev)
    kf = torch.randn(nb, kvh, blk, hd, generator=gen, device=dev)
    vf = torch.randn(nb, kvh, blk, hd, generator=gen, device=dev)
    kab, vab = s2fp8.compute_stats(kf), s2fp8.compute_stats(vf)
    kp = s2fp8_quant.quant_apply(kf, kab)
    vp = s2fp8_quant.quant_apply(vf, vab)
    table = (torch.randperm(nb - 1, generator=gen, device=dev) + 1).reshape(
        b, max_b).to(torch.int32)
    table[0] = 0                                  # a dead slot
    pos = torch.tensor([0, 15, 255, 256, 400, 639], dtype=torch.int32,
                       device=dev)
    ok = paged_attention.paged_decode_attention(q, kp, vp, kab, vab, table,
                                                pos)
    op = paged_attention.paged_decode_plain(q, kp, vp, kab, vab, table, pos)
    assert bool(((ok - op).abs() <= 1e-4 * op.abs() + 1e-5).all())
    assert torch.equal(ok, paged_attention.paged_decode_attention(
        q, kp, vp, kab, vab, table, pos))
    assert kernels.counts()["paged_decode"]["launches"] == 2


def test_paged_decode_kernel_refuses_other_head_dims(dev):
    for hd in (8, 24, 272):
        q = torch.zeros((1, 1, 1, hd), device=dev)
        pool = torch.zeros((2, 1, 16, hd), dtype=torch.uint8,
                           device=dev).view(torch.float8_e5m2)
        ab = torch.tensor([1.0, 0.0], device=dev)
        with pytest.raises(ValueError, match="multiples of 16"):
            paged_attention.paged_decode_attention(
                q, pool, pool, ab, ab, torch.ones((1, 1), dtype=torch.int32,
                                                  device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))
