"""The schedule of the stats kernel and of quantize-with-stats, replayed
on the CPU (no GPU needed), against the plain versions and the JAX
reference.

The CUDA kernels (``csrc/s2fp8_quant.cu``: ``stats_kernel``,
``quant_fused_kernel``; the element map in ``csrc/s2fp8_common.cuh``)
split x into a scalar head before its first 16-byte boundary, whole
16-byte vectors and a tail; vector j goes to thread j mod G of a grid of
G = blocks x 256 threads (blocks = ceil(n / 4096), at most what the card
holds), in round j / G. A thread sums log2|x| in f64 in round order,
each vector's elements in order, its edge element last; the warps reduce
by a shuffle tree (lane i takes lane i + 16, 8, 4, 2, 1), the block's
eight warp totals by the same tree; the partials are summed by 256
threads, thread t taking partials t, t + 256, ... in order, and the same
two trees: in the last block to finish, or, in a fused launch of up to
64 blocks, in every block after the grid barrier (the same bits either
way). Quantize-with-stats keeps each element's log2 and sign bit for a
thread's first 8 elements in registers and its next rounds in shared
memory, and reads the rest (and the edge elements) again. Here that
schedule is replayed in numpy on small "cards" (1 to 3 blocks, 0 to 3
shared-memory rounds), for sizes on both sides of the register and
shared-memory capacity, aligned and ragged, f32 and bf16, and for inputs
of zeros, of one constant and with NaNs.

Tolerances, as on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py phase 3): the triplet's max and nonzero count equal to
``stats_partials_plain``'s, its sum within 1e-6 relative (f64 sums in
another order), (alpha, beta) within 4 ulp; every element encoded once,
read once when kept and twice otherwise; the payload, encoded from the
kept log2 and sign bits through the code table, equal bit for bit to
``quant_apply_plain(x, replayed stats)``.  Against the JAX
``stats_pallas`` / ``quant_pallas`` in interpret mode, the budget of
tests/test_torch_fused_stats.py: count exact, max within 1e-6 relative,
sum within 1e-5 relative, alpha within 1e-4 relative, beta within 1e-4
relative + 1e-3, payloads at least 99.7% equal, each side with its own
stats.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_quant_search import (BUCKET_T0, BUCKETS_PER_UNIT, MAX_CODE,
                                     N_BUCKETS, build_tables)
from torch_threads import one_torch_thread  # noqa: F401

from repro.kernels import dispatch as jdispatch
from repro_torch.core import s2fp8
from repro_torch.kernels import s2fp8_quant

jax.config.update("jax_platform_name", "cpu")

THREADS, GRID_ELEMS, KEEP_ELEMS, WARP = 256, 16, 8, 32


@pytest.fixture(scope="module")
def tables():
    return {fmt: build_tables(fmt) for fmt in ("e5m2", "e4m3")}


def _tree(sums, maxs, counts):
    """The warp shuffle tree over the last axis (32 lanes): lane i takes
    lane i + off for off = 16, 8, 4, 2, 1; lane 0's result."""
    for off in (16, 8, 4, 2, 1):
        sums = np.concatenate([sums[..., :WARP - off] + sums[..., off:WARP],
                               sums[..., WARP - off:]], -1)
        maxs = np.concatenate([np.fmax(maxs[..., :WARP - off],
                                       maxs[..., off:WARP]),
                               maxs[..., WARP - off:]], -1)
        counts = np.concatenate([counts[..., :WARP - off]
                                 + counts[..., off:WARP],
                                 counts[..., WARP - off:]], -1)
    return sums[..., 0], maxs[..., 0], counts[..., 0]


def _block_reduce(sums, maxs, counts):
    """``stats_block_reduce`` of [..., 256] thread values: each warp's
    tree, then warp 0's tree over the 8 warp totals (lanes 8-31 the
    identity)."""
    shape = sums.shape[:-1]
    split = (*shape, THREADS // WARP, WARP)
    ws, wm, wc = _tree(sums.reshape(split), maxs.reshape(split),
                       counts.reshape(split))
    pad = WARP - THREADS // WARP
    ws = np.concatenate([ws, np.zeros((*shape, pad))], -1)
    wm = np.concatenate([wm, np.full((*shape, pad), -np.inf, np.float32)],
                        -1)
    wc = np.concatenate([wc, np.zeros((*shape, pad), np.int64)], -1)
    return _tree(ws, wm, wc)


def replay(x: torch.Tensor, offset: int, blocks_cap: int, rounds_cap: int,
           fmt: str, tabs):
    """The stats kernel and quantize-with-stats on a card of
    ``blocks_cap`` resident blocks keeping ``rounds_cap`` rounds a thread
    in shared memory; x starts ``offset`` elements past a 16-byte
    boundary.  Returns (triplet f32 [3], ab f32 [2], payload uint8, reads
    per element, elements kept)."""
    n, elt = x.numel(), x.element_size()
    vec = 16 // elt
    kv = KEEP_ELEMS // vec
    head = min((16 - offset * elt % 16) % 16 // elt, n)
    nvec = (n - head) // vec
    edges = n - nvec * vec
    blocks = min(max(-(-n // (THREADS * GRID_ELEMS)), 1), blocks_cap)
    grid = blocks * THREADS
    rounds = -(-nvec // grid)
    smem_rounds = min(rounds_cap, max(0, rounds - kv))
    logs = torch.log2(x.float().abs()).numpy()      # the whole tensor at once
    live = logs > -np.inf

    # phase 0: each thread in round order, each vector's elements in order
    sums = np.zeros(grid)
    maxs = np.full(grid, -np.inf, np.float32)
    counts = np.zeros(grid, np.int64)
    reads = np.zeros(n, np.int64)
    kept = np.zeros(n, bool)
    g = np.arange(grid)

    def add(idx, on):
        idx = np.where(on, idx, 0)
        take = on & live[idx]
        sums[take] += logs[idx[take]].astype(np.float64)
        maxs[take] = np.fmax(maxs[take], logs[idx[take]])
        counts[take] += 1
        reads[idx[on]] += 1

    for r in range(rounds):
        j = g + r * grid
        on = j < nvec
        for e in range(vec):
            idx = head + j * vec + e
            add(idx, on)
            if r < kv + smem_rounds:
                kept[idx[on]] = True
    edge = np.where(g < head, g, g + nvec * vec)
    add(edge, g < edges)

    # the block partials, then their sum in index order by 256 threads
    bs, bm, bc = _block_reduce(sums.reshape(blocks, THREADS),
                               maxs.reshape(blocks, THREADS),
                               counts.reshape(blocks, THREADS))
    ts = np.zeros(THREADS)
    tm = np.full(THREADS, -np.inf, np.float32)
    tc = np.zeros(THREADS, np.int64)
    for i in range(blocks):
        ts[i % THREADS] += bs[i]
        tm[i % THREADS] = np.fmax(tm[i % THREADS], bm[i])
        tc[i % THREADS] += bc[i]
    s, m, c = _block_reduce(ts, tm, tc)
    triplet = torch.from_numpy(np.array([s, m, c]).astype(np.float32))
    alpha, beta = s2fp8.stats_from_reduction(
        triplet[0], triplet[1], triplet[2], s2fp8.FMT_TARGET_MAX[fmt])
    ab = torch.stack([alpha, beta])

    # phase 1: every element from its log2 and sign bit (the kept ones
    # from registers or shared memory, the rest after a second read)
    neg = torch.from_numpy(np.signbit(x.float().numpy()))
    payload = log_encode(torch.from_numpy(logs), neg, ab, fmt, tabs)
    reads[~kept] += 1
    return triplet, ab, payload, reads, int(kept.sum())


def log_encode(l: torch.Tensor, neg: torch.Tensor, ab, fmt: str, tabs):
    """uint8 codes as ``encode_log`` makes them from l = log2|x| and x's
    sign bit: the rounded multiply-add, the bucket of t and one threshold
    compare; zeros and NaNs (l not above -inf) give 0."""
    thr, base = tabs
    t = ab[0] * l + ab[1]
    lo = BUCKET_T0 * BUCKETS_PER_UNIT
    b = torch.clamp(torch.floor(torch.nan_to_num(t, nan=0.0)
                                * BUCKETS_PER_UNIT), lo, lo + N_BUCKETS - 1)
    c = base[b.long() - lo]
    c = c + (t >= thr[c + 1]).long()
    c = c | torch.where(neg, 0x80, 0)
    c = torch.where(torch.isnan(t), 0x80 | MAX_CODE[fmt], c)
    return torch.where(l > -math.inf, c, 0).to(torch.uint8)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    d = (a.float().view(torch.int32).long()
         - b.float().view(torch.int32).long()).abs()
    return int(d.max()) if d.numel() else 0


def _input(n: int, offset: int, dtype, seed: int) -> torch.Tensor:
    """n elements one ``offset`` past a 16-byte boundary (a view of a
    fresh tensor), magnitudes over 2^-20 .. 2^20, a zero every 13th."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(n + offset) * np.exp2(
        rng.uniform(-20, 20, n + offset))).astype(np.float32)
    v[::13] = 0.0
    return torch.from_numpy(v).to(dtype)[offset:]


def _check(x, offset, blocks_cap, rounds_cap, fmt, tabs):
    triplet, ab, payload, reads, kept = replay(x, offset, blocks_cap,
                                               rounds_cap, fmt, tabs)
    tp, abp = s2fp8_quant.stats_partials_plain(x, s2fp8.FMT_TARGET_MAX[fmt])
    assert torch.equal(triplet[1:], tp[1:]), (triplet, tp)
    assert (triplet[0] - tp[0]).abs() <= 1e-6 * tp[0].abs(), (triplet, tp)
    assert _ulps(ab, abp) <= 4, (ab, abp)
    want = s2fp8_quant.quant_apply_plain(x, ab, fmt).view(torch.uint8)
    assert torch.equal(payload.reshape(want.shape), want)
    assert np.isin(reads, (1, 2)).all()
    return reads, kept


# (blocks the card holds, shared-memory rounds it keeps)
CARDS = [(1, 0), (2, 3), (3, 2)]
SIZES = ["1", "7", "reg-1", "reg+1", "cap-1", "cap", "cap+1", "cap+3rounds"]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("card", CARDS, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_schedule_matches_plain(tables, fmt, dtype, card, size, offset):
    """The replayed stats and payload against the plain versions, on both
    sides of the register capacity (blocks x 256 threads x 8 elements) and
    of the whole capacity (plus the shared-memory rounds); exactly the
    elements past the capacity, and the edge elements, are read twice."""
    blocks, rounds = card
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    grid = blocks * THREADS
    reg, cap = grid * KEEP_ELEMS, grid * (KEEP_ELEMS + rounds * vec)
    n = {"1": 1, "7": 7, "reg-1": reg - 1, "reg+1": reg + 1,
         "cap-1": cap - 1, "cap": cap, "cap+1": cap + 1,
         "cap+3rounds": cap + 3 * grid * vec + 5}[size]
    x = _input(n, offset, dtype, seed=n + offset)
    reads, kept = _check(x, offset, blocks, rounds, fmt, tables[fmt])
    elt = x.element_size()
    head = min((16 - offset * elt % 16) % 16 // elt, n)
    body = (n - head) // vec * vec
    # the whole vectors up to the capacity are kept (below the register
    # capacity the grid shrinks and keeps all), the edges and the rest are
    # read twice
    assert kept == min(body, cap)
    assert int((reads == 2).sum()) == n - kept


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["zeros", "constant", "nans"])
def test_schedule_degenerate_inputs(tables, kind, dtype):
    """All zeros give (1, 0) and zero codes; a constant a pure shift; NaNs
    are left out of the stats and encode to 0; on a card of 2 blocks and 3
    shared-memory rounds, one element past its capacity."""
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    n = 2 * THREADS * (KEEP_ELEMS + 3 * vec) + 1
    if kind == "zeros":
        x = torch.zeros(n, dtype=dtype)
    elif kind == "constant":
        x = torch.full((n,), -2.75, dtype=dtype)
    else:
        x = _input(n, 0, dtype, seed=3)
        x[::3] = math.nan
    triplet, ab, payload, _, _ = replay(x, 0, 2, 3, "e5m2", tables["e5m2"])
    _check(x, 0, 2, 3, "e5m2", tables["e5m2"])
    if kind == "zeros":
        assert triplet.tolist() == [0.0, -math.inf, 0.0]
        assert ab.tolist() == [1.0, 0.0] and not payload.any()
    elif kind == "constant":
        assert float(ab[0]) == 1.0 and (payload == payload[0]).all()
    else:
        assert float(triplet[2]) == float((~torch.isnan(x) & (x != 0)).sum())
        assert not payload[::3].any()


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_schedule_against_jax_reference(tables, dtype, fmt):
    """The replayed stats and payload (a card of 3 blocks and 2
    shared-memory rounds, a ragged 129 x 257 input past its capacity)
    against the JAX ``stats_pallas`` / ``quant_pallas`` in interpret mode,
    within the parity budget above."""
    rng = np.random.default_rng(17)
    xf = (rng.standard_normal((129, 257)) * np.exp2(
        rng.uniform(-12, 12, (129, 257)))).astype(np.float32)
    xf[::7, ::11] = 0.0
    x = torch.from_numpy(xf).to(dtype)
    xf = x.float().numpy()
    triplet, ab, payload, _, _ = replay(x.flatten(), 0, 3, 2, fmt,
                                        tables[fmt])
    jx = jnp.asarray(xf)
    js, jm, jc = jdispatch.stats_partials_nd(jx, interpret=True)
    absx = np.abs(xf.astype(np.float64))
    assert float(triplet[2]) == float(jc)
    np.testing.assert_allclose(float(triplet[1]), float(jm), rtol=1e-6)
    np.testing.assert_allclose(float(triplet[0]), float(js), rtol=1e-5)
    np.testing.assert_allclose(float(triplet[0]),
                               np.log2(absx[absx > 0]).sum(), rtol=1e-5)
    jp, ja, jb = jdispatch.quant_nd(jx, fmt=fmt, interpret=True)
    np.testing.assert_allclose(float(ab[0]), float(ja), rtol=1e-4)
    np.testing.assert_allclose(float(ab[1]), float(jb), rtol=1e-4,
                               atol=1e-3)
    jcodes = np.asarray(jax.lax.bitcast_convert_type(jp, jnp.uint8))
    assert (payload.numpy().reshape(xf.shape) == jcodes).mean() >= 0.997
