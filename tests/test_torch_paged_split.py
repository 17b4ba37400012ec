"""The split-KV paged decode, emulated in plain torch on the CPU.

The CUDA kernel (``csrc/paged_attention.cu``) splits each slot's cache
into runs of ``SPLIT`` positions.  Inside a split, a lane group reads one
payload row at a time: hd / 16 lanes rounded up to a power of two (the
extra lanes idle and add 0), so the block's 128 threads make 128 / that
many groups, and group ``r`` takes rows s0 + r, s0 + r + groups, ... with
an online softmax (m, l, acc).  The groups of a warp merge
into its first group by a shuffle tree (offsets 16, 8, ... lanes), the
warps in warp order (max first, then the sums), and the slot's last split
to finish merges its live splits in split order the same way.  Here that schedule is
replayed step by step in f32 torch ops at several split lengths (the
kernel's among them), and held against the port's ``paged_decode_plain``
and the JAX ``paged_decode_reference`` on the same numpy inputs, with the
payloads quantized on the JAX side and shared bit for bit.

Cases: positions 0 (a dead slot whose table row is all trash block 0), 15,
16, split - 1, split and the last position of the table; G in {1, 3}; hd in
{16, 64, 128, 160, 192} (1, 4, 8 and two padded groups of 16 lanes); e5m2
and e4m3.  Tolerance: |emulation - plain| and |emulation
- reference| <= 2e-5 + 2e-5 * |plain| (the reference's own
kernel-vs-oracle tolerance, tests/test_serving.py); only the order of f32
sums and the softmax's rescaling differ.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.core import s2fp8 as js2
from repro.kernels import paged_attention as jpa
from repro_torch.core import s2fp8 as ts2
from repro_torch.kernels import paged_attention, ref

jax.config.update("jax_platform_name", "cpu")

THREADS, WARP = 128, 32
MASK = -1e30
BLOCK, MAX_BLOCKS = 16, 24            # 384 positions a slot
STATS = {"k": (4.0, 1.5), "v": (3.0, -0.5)}


def _merge(m, l, acc, mo, lo, acco):
    """(m, l, acc) and (mo, lo, acco) merged as the kernel's shuffle tree:
    the new max, each side rescaled to it."""
    mn = torch.maximum(m, mo)
    ca, cb = torch.exp(m - mn), torch.exp(mo - mn)
    return mn, l * ca + lo * cb, acc * ca[..., None] + acco * cb[..., None]


def _ordered(m, l, acc, dim):
    """Partials along ``dim`` merged in index order, max first (the
    kernel's warp merge and its split combine)."""
    mx = m.max(dim=dim, keepdim=True).values
    mx = torch.maximum(mx, torch.tensor(MASK))
    c = torch.exp(m - mx)
    ls = torch.zeros_like(mx.squeeze(dim))
    a = torch.zeros_like(acc.select(dim, 0))
    for i in range(m.shape[dim]):
        ls = ls + l.select(dim, i) * c.select(dim, i)
        a = a + acc.select(dim, i) * c.select(dim, i)[..., None]
    return mx.squeeze(dim), ls, a


def split_decode_emulation(q, kf, vf, positions, split):
    """The kernel's schedule on dequantized, gathered K / V.

    q: [B, KV, G, hd]; kf, vf: [B, KV, S, hd] (S = the table's positions);
    positions: [B].  Returns [B, KV, G, hd]."""
    b, kvh, g, hd = q.shape
    s_len = kf.shape[2]
    lanes = 1 << (hd // 16 - 1).bit_length()     # padded to a power of two
    groups = THREADS // lanes
    per_warp = WARP // lanes
    rounds = -(-split // groups)
    nsplit = -(-s_len // split)
    scale = float(torch.tensor(1.0) / torch.sqrt(torch.tensor(float(hd))))
    end = torch.clamp(positions.long() + 1, max=s_len)           # [B]
    parts = []
    for sp in range(nsplit):
        s0 = sp * split
        m = torch.full((b, kvh, g, groups), MASK)
        l = torch.zeros((b, kvh, g, groups))
        acc = torch.zeros((b, kvh, g, groups, hd))
        for k in range(rounds):
            t = s0 + torch.arange(groups) + k * groups            # [NG]
            inside = t < min(s0 + split, s_len)
            tc = torch.clamp(t, max=s_len - 1)
            kr, vr = kf[:, :, tc], vf[:, :, tc]                   # [B,KV,NG,hd]
            s = torch.einsum("bkgd,bknd->bkgn", q, kr) * scale
            live = (inside[None, :] & (t[None, :] < end[:, None]))[:, None,
                                                                    None]
            mn = torch.where(live, torch.maximum(m, s), m)
            corr = torch.exp(m - mn)
            p = torch.where(live, torch.exp(s - mn), torch.zeros(()))
            l = l * corr + p
            acc = acc * corr[..., None] + p[..., None] * vr[:, :, None]
            m = mn
        # each warp's groups into its first, offsets 16, 8, ... lanes
        m = m.reshape(b, kvh, g, -1, per_warp)
        l = l.reshape(b, kvh, g, -1, per_warp)
        acc = acc.reshape(b, kvh, g, -1, per_warp, hd)
        step = per_warp // 2
        while step >= 1:
            lo, hi = slice(0, step), slice(step, 2 * step)
            mm, ll, aa = _merge(m[..., lo], l[..., lo], acc[..., lo, :],
                                m[..., hi], l[..., hi], acc[..., hi, :])
            m, l, acc = mm, ll, aa
            step //= 2
        parts.append(_ordered(m[..., 0], l[..., 0], acc[..., 0, :], dim=3))
    pm = torch.stack([p[0] for p in parts], dim=3)               # [B,KV,G,NS]
    pl = torch.stack([p[1] for p in parts], dim=3)
    pa = torch.stack([p[2] for p in parts], dim=3)
    live_splits = -(-end // split)                               # [B]
    dead = torch.arange(nsplit)[None, :] >= live_splits[:, None]
    pm = torch.where(dead[:, None, None], torch.tensor(MASK), pm)
    pl = torch.where(dead[:, None, None], torch.zeros(()), pl)
    pa = torch.where(dead[:, None, None, :, None], torch.zeros(()), pa)
    _, ls, a = _ordered(pm, pl, pa, dim=3)
    return a / torch.where(ls == 0, torch.ones(()), ls)[..., None]


@functools.lru_cache(maxsize=None)
def _case(fmt, g, hd, split):
    """Numpy inputs, payloads quantized by the JAX side, the JAX
    reference's output, and the port's tensors."""
    kvh, nb = 2, 6 * MAX_BLOCKS + 1
    last = MAX_BLOCKS * BLOCK - 1
    positions = np.array([0, 15, 16, split - 1, split, last], np.int32)
    b = positions.size
    rng = np.random.default_rng(split + 7 * g + hd)
    q = rng.standard_normal((b, kvh, g, hd)).astype(np.float32)
    kf = rng.standard_normal((nb, kvh, BLOCK, hd)).astype(np.float32)
    vf = rng.standard_normal((nb, kvh, BLOCK, hd)).astype(np.float32)
    table = (rng.permutation(nb - 1)[:b * MAX_BLOCKS] + 1).reshape(
        b, MAX_BLOCKS).astype(np.int32)
    table[0] = 0                         # the dead slot: trash block only
    kp = js2.quantize(jnp.asarray(kf), stats=STATS["k"], fmt=fmt).payload
    vp = js2.quantize(jnp.asarray(vf), stats=STATS["v"], fmt=fmt).payload
    want = np.array(jpa.paged_decode_reference(
        jnp.asarray(q), kp, vp, *STATS["k"], *STATS["v"], jnp.asarray(table),
        jnp.asarray(positions)))

    def payload(p):
        u8 = np.asarray(jax.lax.bitcast_convert_type(p, jnp.uint8)).copy()
        return torch.from_numpy(u8).view(ts2.FMT_QDTYPE[fmt])

    return (torch.from_numpy(q), payload(kp), payload(vp),
            torch.from_numpy(table), torch.from_numpy(positions), want)


def _gathered(pool, table, stats):
    """[B, KV, S, hd] f32: the slots' blocks through the table,
    dequantized."""
    b, max_b = table.shape
    _, kvh, blk, hd = pool.shape
    u8 = pool.view(torch.uint8)[table.long()].movedim(1, 2)
    u8 = u8.reshape(b, kvh, max_b * blk, hd).view(pool.dtype)
    return ref.s2fp8_dequant_ref(u8, torch.tensor(stats))


def _close(got, want):
    return bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs()).all())


@pytest.mark.parametrize("split", [64, 128, paged_attention.SPLIT])
@pytest.mark.parametrize("hd", [16, 64, 128, 160, 192])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_split_emulation_matches_plain_and_reference(fmt, g, hd, split):
    q, kp, vp, table, positions, want = _case(fmt, g, hd, split)
    kf = _gathered(kp, table, STATS["k"])
    vf = _gathered(vp, table, STATS["v"])
    got = split_decode_emulation(q, kf, vf, positions, split)
    plain = paged_attention.paged_decode_plain(
        q, kp, vp, torch.tensor(STATS["k"]), torch.tensor(STATS["v"]), table,
        positions, fmt)
    assert torch.isfinite(got).all()
    assert _close(got, plain), (got - plain).abs().max()
    assert _close(got, torch.from_numpy(want)), \
        (got - torch.from_numpy(want)).abs().max()


def test_split_emulation_dead_slot_reads_trash_row():
    """Position 0 of a slot whose table row is all trash block 0 attends
    one row: the output is that row's dequantized V, finite."""
    q, kp, vp, table, positions, _ = _case("e5m2", 3, 64,
                                           paged_attention.SPLIT)
    vf = _gathered(vp, table, STATS["v"])
    got = split_decode_emulation(q, _gathered(kp, table, STATS["k"]), vf,
                                 positions, paged_attention.SPLIT)
    want = vf[0, :, None, 0].expand(-1, q.shape[2], -1)
    assert torch.equal(got[0], want)
