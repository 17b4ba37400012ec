"""The exp2-free encode of quantize-apply, truncate-apply and the fused
truncate, emulated in torch on the CPU (no GPU needed).

The CUDA kernels (``csrc/s2fp8_common.cuh``: ``code_from_t``,
``encode_log``; ``csrc/s2fp8_quant.cu``) replace exp2f, the clamp and
the fp8 convert of the forward map by a table built once per format: the
least t = alpha log2|x| + beta at which the magnitude code reaches each
value (by bisection over f32 bit patterns), and the code at the start of
each 1/16-wide bucket of t. Truncate-apply and the fused truncate then
write Eq. 5 as a 256-entry table of decoded codes indexed by that
encode. Here the same tables are built from ``torch.exp2`` and the plain
cast (as the kernel builds them from exp2f and its convert), and the
emulated maps are held bit for bit against the port's plain versions
``quant_apply_plain`` / ``truncate_apply_plain``: over all 65,536 bf16
bit patterns, a dense f32 sweep (subnormals, zeros of both signs, NaN,
+-inf, values past saturation) and f32 and bf16 tensors of ragged length
one element past a 16-byte boundary (through truncate-apply's element
map: scalar head and tail, 16-byte vectors, lut[code]), both formats, at
several (alpha, beta).  Tolerance: none —
the emulation must equal the plain version exactly, as the kernel must
equal the direct map (the on-card sweep in tests/test_torch_kernels_cuda.py).
Also inputs within 48 ulp of every code threshold, where a bucket or
threshold off by one would show; the near-threshold cases of
tests/test_torch_kernels_cuda.py hold the kernels there on the card.

Against the JAX reference's ``quant_apply_pallas`` / ``truncate_apply_pallas``
(``_apply_kernel`` / ``_truncate_body``) in interpret mode, with shared
(alpha, beta), the repo's parity budget (ROADMAP queue 3, "Parity is a
budget"; the tolerances of tests/test_torch_fused_stats.py): payloads at
least 99.8% equal and never more than one grid step apart; truncated
values zero for zero in over 99.5% of the elements, on the common nonzeros
at least 99.8% within 1e-3 relative and all within 0.1.

Last, the fused truncate's element map (16-byte vectors round-robin over
the grid's threads, a scalar head before the first 16-byte boundary and a
tail; each thread's first 16 elements kept in registers across the grid
barrier, the rest re-read last round first) is emulated on a small card
and held to cover every element once, to read twice exactly the elements
past its register capacity (and the edge elements), and to give
``truncate_apply(x, stats(x))`` bit for bit, for sizes on both sides of
the capacity and both alignments.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.kernels import dispatch as jdispatch
from repro.kernels.s2fp8_quant import (quant_apply_pallas,
                                       truncate_apply_pallas)
from repro_torch.core import s2fp8
from repro_torch.kernels import s2fp8_quant

jax.config.update("jax_platform_name", "cpu")

BUCKETS_PER_UNIT, BUCKET_T0, N_BUCKETS = 16, -32, 1024
MAX_CODE = {"e5m2": 0x7B, "e4m3": 0x7E}
KEEP_ELEMS, THREADS = 16, 256
STATS = [(1.0, 0.0), (1.0, 15.0), (0.37, 2.1), (2.5, -7.25)]


def _direct_mag(t: torch.Tensor, fmt: str) -> torch.Tensor:
    """Magnitude code of t by the direct map: exp2, clamp, RNE cast."""
    fmax = s2fp8.FMT_MAX_FINITE[fmt]
    y = torch.clamp(torch.exp2(t), -fmax, fmax)
    return (y.to(s2fp8.FMT_QDTYPE[fmt]).view(torch.uint8) & 0x7F).long()


def _key_to_float(key: torch.Tensor) -> torch.Tensor:
    """f32 of its order key (0 is +-0, +-0x7f800000 are +-inf)."""
    bits = torch.where(key >= 0, key, (-key) | 0x80000000)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def build_tables(fmt: str):
    """(thr f32 [128], base int64 [1024]) as build_code_table_kernel."""
    k = torch.arange(1, 128)
    lo = torch.full((127,), -0x7F800000, dtype=torch.int64)
    hi = torch.full((127,), 0x7F800000, dtype=torch.int64)
    while bool((lo < hi).any()):
        mid = lo + (hi - lo) // 2
        up = _direct_mag(_key_to_float(mid), fmt) >= k
        hi = torch.where(up & (lo < hi), mid, hi)
        lo = torch.where(~up & (lo < hi), mid + 1, lo)
    thr = torch.cat([torch.tensor([-math.inf]), _key_to_float(lo)])
    thr[MAX_CODE[fmt] + 1:] = math.nan
    t = (torch.arange(N_BUCKETS) + BUCKET_T0 * BUCKETS_PER_UNIT).float() \
        / BUCKETS_PER_UNIT
    t[0] = -math.inf
    return thr, _direct_mag(t, fmt)


@pytest.fixture(scope="module")
def tables():
    return {fmt: build_tables(fmt) for fmt in ("e5m2", "e4m3")}


def table_encode(x: torch.Tensor, ab, fmt: str, tabs) -> torch.Tensor:
    """uint8 codes of x, as quant_apply_kernel computes them: log2f, the
    rounded multiply-add, the bucket of t and one threshold compare."""
    thr, base = tabs
    xf = x.float()
    ab = s2fp8.as_stats(ab)
    t = ab[0] * torch.log2(xf.abs()) + ab[1]
    lo = BUCKET_T0 * BUCKETS_PER_UNIT
    b = torch.clamp(torch.floor(torch.nan_to_num(t, nan=0.0)
                                * BUCKETS_PER_UNIT), lo, lo + N_BUCKETS - 1)
    c = base[b.long() - lo]
    c = c + (t >= thr[c + 1]).long()
    c = c | torch.where(xf < 0, 0x80, 0)
    c = torch.where(torch.isnan(t), 0x80 | MAX_CODE[fmt], c)
    return torch.where(xf.abs() > 0, c, 0).to(torch.uint8)


def decode_lut(ab, fmt: str) -> torch.Tensor:
    """f32 [256]: the Eq. 4 value of every payload byte."""
    codes = torch.arange(256, dtype=torch.uint8).view(s2fp8.FMT_QDTYPE[fmt])
    return s2fp8.dequantize(s2fp8.S2FP8Tensor(codes, s2fp8.as_stats(ab),
                                              fmt))


def table_truncate(x: torch.Tensor, ab, fmt: str, tabs) -> torch.Tensor:
    """Eq. 5 as the fused truncate's phase 1: lut[encode(x)], in x's
    dtype."""
    lut = decode_lut(ab, fmt).to(x.dtype)
    return lut[table_encode(x, ab, fmt, tabs).long()]


def _f32_sweep() -> torch.Tensor:
    """A dense f32 sweep: every 4,099th bit pattern (NaNs and infs among
    them), subnormals, both zeros, +-inf, NaN, the extremes, and a
    log-spaced sweep from 2^-149 to 2^127 with its negatives."""
    bits = np.arange(0, 2 ** 32, 4099, dtype=np.int64)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                        np.finfo(np.float32).tiny, np.finfo(np.float32).max,
                        -np.finfo(np.float32).max, 1.4e-45, -1.4e-45,
                        57344.0, 448.0, 1e30, -1e30], dtype=np.float32)
    sweep = np.exp2(np.linspace(-149.0, 127.9, 200_003)).astype(np.float32)
    sub = (np.arange(1, 2 ** 23, 97, dtype=np.int64)).astype(np.int32)
    parts = [torch.from_numpy(np.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
                              .astype(np.int32)).view(torch.float32),
             torch.from_numpy(special), torch.from_numpy(sweep),
             -torch.from_numpy(sweep),
             torch.from_numpy(sub).view(torch.float32)]
    return torch.cat(parts)


ALL_BF16 = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
    torch.int16).view(torch.bfloat16)


def _ragged(dtype) -> torch.Tensor:
    """100,003 elements one past a 16-byte boundary (a view from element
    1), magnitudes over 2^-40 .. 2^40 with zeros: a head, whole vectors and
    a tail for truncate-apply's element map."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(100_004) * np.exp2(
        rng.uniform(-40, 40, 100_004))).astype(np.float32)
    x[::89] = 0.0
    return torch.from_numpy(x).to(dtype)[1:]


def truncate_apply_emulation(x: torch.Tensor, ab, fmt: str, tabs,
                             offset: int) -> torch.Tensor:
    """Truncate-apply's element map, x starting ``offset`` elements past a
    16-byte boundary: the head before the first boundary and the tail after
    the last whole 16-byte vector as scalars, the vectors between, each
    element through lut[encode(x)] exactly once."""
    n, elt = x.numel(), x.element_size()
    vec = 16 // elt
    head = min((16 - offset * elt % 16) % 16 // elt, n)
    nvec = (n - head) // vec
    body = slice(head, head + nvec * vec)
    out = torch.empty_like(x)
    writes = torch.zeros(n, dtype=torch.int64)
    for part in (slice(0, head), body, slice(head + nvec * vec, n)):
        out[part] = table_truncate(x[part], ab, fmt, tabs)
        writes[part] += 1
    assert bool((writes == 1).all())
    return out


def test_tables_have_one_threshold_per_bucket(tables):
    """The thresholds ascend, the format's codes 1..max are each reached,
    and no bucket of t holds two thresholds (the premise of the single
    compare)."""
    for fmt, (thr, base) in tables.items():
        m = MAX_CODE[fmt]
        steps = thr[1:m + 1]
        assert bool((steps[1:] > steps[:-1]).all()), fmt
        assert bool(torch.isnan(thr[m + 1:]).all())
        bucket = torch.floor(steps * BUCKETS_PER_UNIT).long()
        assert bucket.unique().numel() == m, fmt
        assert int(base[0]) == 0 and int(base[-1]) == m
        assert bool((base[1:] >= base[:-1]).all())


@pytest.mark.parametrize("ab", STATS, ids=str)
@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
@pytest.mark.parametrize("inputs", ["bf16_all", "f32_sweep", "f32_ragged",
                                    "bf16_ragged"])
def test_table_encode_and_truncate_equal_plain(tables, fmt, ab, inputs):
    """The table encode and lut[encode] truncate against the plain
    versions; the ragged inputs go through truncate-apply's element map
    (scalar head and tail, 16-byte vectors)."""
    x = {"bf16_all": lambda: ALL_BF16, "f32_sweep": _f32_sweep,
         "f32_ragged": lambda: _ragged(torch.float32),
         "bf16_ragged": lambda: _ragged(torch.bfloat16)}[inputs]()
    want = s2fp8_quant.quant_apply_plain(x, ab, fmt).view(torch.uint8)
    got = table_encode(x, ab, fmt, tables[fmt])
    bad = (got != want).nonzero().flatten()
    assert bad.numel() == 0, (bad.numel(), x[bad[:5]], got[bad[:5]],
                              want[bad[:5]])
    tw = s2fp8_quant.truncate_apply_plain(x, ab, fmt)
    tg = (truncate_apply_emulation(x, ab, fmt, tables[fmt], 1)
          if inputs.endswith("ragged")
          else table_truncate(x, ab, fmt, tables[fmt]))
    assert tg.dtype == x.dtype
    ints = torch.int32 if x.dtype == torch.float32 else torch.int16
    assert torch.equal(tg.view(ints), tw.view(ints))   # bit for bit


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_table_encode_against_jax_reference(tables, fmt):
    """The emulated maps against the JAX Pallas kernels (interpret mode)
    with the same (alpha, beta): the parity budget above."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((129, 257)) * np.exp2(
        rng.uniform(-12, 12, (129, 257)))).astype(np.float32)
    x[::7, ::11] = 0.0
    ab = s2fp8.compute_stats(torch.from_numpy(x), s2fp8.FMT_TARGET_MAX[fmt])
    a, b = float(ab[0]), float(ab[1])
    jx = jdispatch.as_blocked_2d(jnp.asarray(x))
    jp = jdispatch.from_blocked_2d(quant_apply_pallas(
        jx, a, b, fmt=fmt, interpret=True), x.shape)
    jcodes = np.asarray(jax.lax.bitcast_convert_type(jp, jnp.uint8))
    codes = table_encode(torch.from_numpy(x), ab, fmt, tables[fmt]).numpy()

    def ordinal(u):
        u = u.astype(np.int32)
        return np.where(u >= 0x80, -(u & 0x7F), u & 0x7F)
    steps = np.abs(ordinal(codes) - ordinal(jcodes))
    assert (steps == 0).mean() >= 0.998 and steps.max() <= 1
    jt = np.asarray(jdispatch.from_blocked_2d(truncate_apply_pallas(
        jx, a, b, fmt=fmt, interpret=True), x.shape))
    t = table_truncate(torch.from_numpy(x), ab, fmt, tables[fmt]).numpy()
    assert ((t == 0) == (jt == 0)).mean() > 0.995
    nz = (t != 0) & (jt != 0)
    rel = np.abs(t[nz] - jt[nz]) / np.abs(jt[nz])
    assert (rel <= 1e-3).mean() >= 0.998 and rel.max() <= 0.1


def fused_emulation(x: torch.Tensor, fmt: str, tabs, blocks: int,
                    offset: int):
    """The fused truncate on a card whose grid is ``blocks`` blocks of 256
    threads, x starting ``offset`` elements past a 16-byte boundary.
    Returns (out, ab, reads per element, elements kept in registers)."""
    n, elt = x.numel(), x.element_size()
    vec = 16 // elt
    kv = KEEP_ELEMS // vec
    head = min((16 - offset * elt % 16) % 16 // elt, n)
    nvec = (n - head) // vec
    edges = n - nvec * vec
    grid = blocks * THREADS
    step = kv * grid
    mags = x.float().abs().numpy().astype(np.float64)
    logs = torch.log2(x.float().abs()).numpy().astype(np.float64)

    def vec_elems(j):
        return range(head + j * vec, head + (j + 1) * vec)

    def edge_index(e):
        return e if e < head else e + nvec * vec

    reads = np.zeros(n, np.int64)
    writes = np.zeros(n, np.int64)
    kept_elems = 0
    partials = []
    # phase 0: rounds in order, the kept batch first; the edge element last
    for g in range(grid):
        s, mx, cnt = 0.0, -math.inf, 0
        j0 = g
        while j0 < nvec:
            for k in range(kv):
                j = j0 + k * grid
                if j >= nvec:
                    break
                for i in vec_elems(j):
                    reads[i] += 1
                    kept_elems += j0 == g
                    if mags[i] > 0:
                        s, mx, cnt = s + logs[i], max(mx, logs[i]), cnt + 1
            j0 += step
        if g < edges:
            i = edge_index(g)
            reads[i] += 1
            if mags[i] > 0:
                s, mx, cnt = s + logs[i], max(mx, logs[i]), cnt + 1
        partials.append((s, mx, cnt))
    tot_s = sum(p[0] for p in partials)
    tot_m = max(p[1] for p in partials)
    tot_c = sum(p[2] for p in partials)
    alpha, beta = s2fp8.stats_from_reduction(
        torch.tensor(tot_s, dtype=torch.float32), torch.tensor(tot_m),
        torch.tensor(float(tot_c)), s2fp8.FMT_TARGET_MAX[fmt])
    ab = torch.stack([alpha, beta])
    # phase 1: the kept batch, then the rest re-read, last batch first
    out_all = table_truncate(x, ab, fmt, tabs)
    out = torch.empty_like(x)
    for g in range(grid):
        for k in range(kv):
            j = g + k * grid
            if j >= nvec:
                break
            for i in vec_elems(j):
                writes[i] += 1
        if g + step < nvec:
            j0 = g + (nvec - 1 - g) // step * step
            while j0 > g:
                for k in range(kv):
                    j = j0 + k * grid
                    if j >= nvec:
                        break
                    for i in vec_elems(j):
                        reads[i] += 1
                        writes[i] += 1
                j0 -= step
        if g < edges:
            i = edge_index(g)
            reads[i] += 1
            writes[i] += 1
    assert (writes == 1).all()
    out.copy_(out_all)
    return out, ab, reads, kept_elems


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("delta", [-1, 0, 1, 2 * KEEP_ELEMS * THREADS + 5])
def test_fused_register_map(tables, delta, dtype, offset):
    """On a card of 2 resident blocks the fused truncate keeps 8,192
    elements in registers; sizes on both sides of that cover every element
    once, read twice exactly the elements past the capacity (and the edge
    elements), and give truncate_apply(x, stats(x))."""
    blocks = 2
    capacity = blocks * THREADS * KEEP_ELEMS
    n = capacity + delta
    rng = np.random.default_rng(n + offset)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dtype)
    x[::13] = 0.0
    fmt = "e5m2"
    out, ab, reads, kept = fused_emulation(x, fmt, tables[fmt], blocks,
                                           offset)
    vec = 16 // x.element_size()
    head = min((16 - offset * x.element_size() % 16) % 16
               // x.element_size(), n)
    body = (n - head) // vec * vec
    assert kept == min(body, capacity)
    assert int((reads == 2).sum()) == n - kept and (reads >= 1).all()
    _, abp = s2fp8_quant.stats_partials_plain(x, s2fp8.FMT_TARGET_MAX[fmt])
    assert torch.allclose(ab, abp, rtol=1e-6, atol=1e-6)
    # truncate_apply(x, stats(x)) as decode(encode(x)) with the emulated
    # stats: the plain encode, then the plain decode of each code.  (The
    # plain truncate on the whole of x is not used here: torch's CPU loop
    # takes exp2 from SLEEF but its ragged tail from the scalar exp2, and
    # the two differ in the last ulp.)
    codes = s2fp8_quant.quant_apply_plain(x, ab, fmt).view(torch.uint8)
    want = decode_lut(ab, fmt).to(dtype)[codes.long()]
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(out.view(ints), want.view(ints))


def _near_thresholds_cpu(thr, fmt, alpha, beta, ulps=48):
    """f32 x of both signs whose t = alpha log2|x| + beta lies within a few
    ulp of each code threshold of ``fmt``."""
    m = MAX_CODE[fmt]
    x = torch.exp2((thr[1:m + 1].double() - beta) / alpha).float()
    bits = x.view(torch.int32)[:, None] + torch.arange(
        -ulps, ulps + 1, dtype=torch.int32)
    x = bits.flatten().view(torch.float32)
    return torch.cat([x, -x])


@pytest.mark.parametrize("ab", STATS, ids=str)
@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_table_encode_near_thresholds(tables, fmt, ab):
    """Inputs within 48 ulp of every code threshold of ``fmt`` under
    (alpha, beta), both signs, in f32 and rounded to bf16: the table encode
    and lut[encode] truncate equal the plain versions bit for bit."""
    thr, _ = tables[fmt]
    x = _near_thresholds_cpu(thr, fmt, *ab)
    x = x[torch.isfinite(x)]
    for xd in (x, x.to(torch.bfloat16)):
        want = s2fp8_quant.quant_apply_plain(xd, ab, fmt).view(torch.uint8)
        got = table_encode(xd, ab, fmt, tables[fmt])
        bad = (got != want).nonzero().flatten()
        assert bad.numel() == 0, (xd[bad[:5]], got[bad[:5]], want[bad[:5]])
        ints = torch.int32 if xd.dtype == torch.float32 else torch.int16
        assert torch.equal(
            table_truncate(xd, ab, fmt, tables[fmt]).view(ints),
            s2fp8_quant.truncate_apply_plain(xd, ab, fmt).view(ints))
