"""The selective-scan kernel's schedule, replayed in plain torch on the CPU.

The CUDA kernel (``csrc/selective_scan.cu``) gives each channel 4 lanes of
a warp, lane ``l`` holding states 4 l .. 4 l + 3 (those below n) and
their entries of A in registers; a block covers ``CHANNELS`` channels of
one batch row and walks the sequence in chunks of ``TCHUNK`` steps, staged
in shared memory with out-of-range copies zero-filled (channels past di,
steps past S, states past n).  A missing state has a = 0 and b = c = 0,
so it stays 0 and adds 0.  Per step each lane updates its states (``h *
exp(dt a) + (dt x) b``, each multiply and add rounded alone), sums its
share of ``h c`` in state order, the four shares are summed over
lane distance 1, then 2 (``__shfl_xor_sync``), and ``D x`` is added to
the total; y is stored for live channels and steps only.  Here that
schedule is replayed block by block, chunk by chunk and step by step in
f32 torch ops, and held against the port's ``selective_scan_plain`` and
the JAX ``selective_scan_pallas`` (interpret mode) on the same numpy
inputs.

Cases: n in {1, 5, 8, 16} (a lane with no state adds 0), di not a multiple
of a block's channels (100: not of 4 either, the kernel's 4-byte path;
136: its 16-byte path with a dead 4-channel group) and S = 37, not a
multiple of the chunk.  Tolerances: h equal to the plain version's bit for
bit (the same rounded ops in the same order; the kernel's expf is the
math library's, here torch's exp on both sides); y within 1e-5 * max |y|
of the plain version's (its sum over the states runs in another order);
against ``selective_scan_pallas``, rtol 1e-4 and atol 1e-5 (the
reference's own tolerance for its kernel against the oracle).

The widened kernel: above 16 states a channel takes 16 lanes (4 states
each, the xor tree over distance 1, 2, 4, 8) and a block 16 channels; the
per-head variant (Mamba-2) reads one dt, A and D a head, one decay a
(step, head).  ``replay`` takes both (n 17, 40, 64; head dims 8, 16, 32,
64), held as above against ``selective_scan_plain``.

The backward kernel's schedule (``replay_bwd``): chunks walked from the
last, each replayed from the chunk state the forward saved, every step's
h kept, then t walked down with g_t = dy_t C_t + g_{t+1} exp(dt_{t+1} A);
a lane's sums over its 4 states in order, then the xor tree; dB and dC of
each step summed over a block's channels in channel order, per head the
ddt, dA and dD over a head's channels in order; the blocks' (and rows')
partials summed by index.  Held against ``selective_scan_bwd_plain``
(autograd through the plain version) within 1e-5 of each gradient's
largest entry (the same terms, summed in another order), and shown not
to depend on the order the blocks run in.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.kernels.selective_scan import selective_scan_pallas
from repro_torch.kernels import selective_scan as tscan

jax.config.update("jax_platform_name", "cpu")

SPL, TCHUNK = 4, 16             # states a lane; the kernel's chunk


def geometry(n):
    """(lanes a channel, channels a block) of the kernel at n states."""
    lanes = 4 if n <= 16 else 16
    return lanes, 256 // lanes


def lane_tree(acc, lanes):
    """The xor-shuffle tree over the last axis (a channel's lanes):
    distance 1, 2, ..., each lane adding its partner's value."""
    idx = torch.arange(lanes)
    off = 1
    while off < lanes:
        acc = acc + acc[..., idx ^ off]
        off *= 2
    return acc


def lane_sums(v, lanes):
    """[..., lanes * SPL] -> [..., lanes]: each lane's sum of its SPL
    states in state order."""
    v = v.reshape(v.shape[:-1] + (lanes, SPL))
    acc = v[..., 0]
    for j in range(1, SPL):
        acc = acc + v[..., j]
    return acc


def per_channel(dt, a, d_skip, di):
    """A per-head call's dt, A and D as the channels read them (the
    kernel's per-head decay is one exp of the same f32 product, so every
    channel of a head gets its bits)."""
    nh = a.shape[0]
    hd = di // nh
    head = torch.arange(di) // hd
    return dt[..., head], a[head][:, None], d_skip[head]


def staged(b, tchunk, channels, live, cols, x, t0, tn):
    """A chunk's [b, tchunk, channels] slab, zero-filled past di and S."""
    out = torch.zeros((b, tchunk, channels))
    out[:, :tn, live] = x[:, t0:t0 + tn, cols[live]]
    return out


def replay(x, dt, bm, cm, a, d_skip, channels=None, tchunk=TCHUNK,
           chunk_states=False):
    """(y, h) of the kernel's schedule: every block of ``channels``
    channels of every batch row (batched here), chunk by chunk; per head
    when A is [nh].  With ``chunk_states`` also the state at the start of
    every chunk [b, chunks, di, n], as the forward saves it."""
    b, s, di = x.shape
    n = bm.shape[-1]
    lanes, block = geometry(n)
    channels = channels or block
    nmax = lanes * SPL
    if a.dim() == 1:
        dt, a, d_skip = per_channel(dt, a, d_skip, di)
        a = a.expand(di, n)
    y = torch.full((b, s, di), float("nan"))
    h_out = torch.empty((b, di, n))
    chunks = torch.empty((b, -(-s // tchunk), di, n))
    for c0 in range(0, di, channels):
        live = torch.arange(c0, c0 + channels) < di
        cols = torch.arange(c0, c0 + channels).clamp(max=di - 1)
        av = torch.zeros((channels, nmax))
        av[:, :n] = a[cols]
        av[~live] = 0.0
        dd = torch.where(live, d_skip[cols], torch.zeros(()))
        h = torch.zeros((b, channels, nmax))
        for k, t0 in enumerate(range(0, s, tchunk)):
            chunks[:, k, cols[live]] = h[:, live, :n]
            tn = min(tchunk, s - t0)
            sx = staged(b, tchunk, channels, live, cols, x, t0, tn)
            sdt = staged(b, tchunk, channels, live, cols, dt, t0, tn)
            sb = torch.zeros((b, tchunk, nmax))
            sc = torch.zeros((b, tchunk, nmax))
            sb[:, :tn, :n] = bm[:, t0:t0 + tn]
            sc[:, :tn, :n] = cm[:, t0:t0 + tn]
            for t in range(tn):
                xt, dtt = sx[:, t, :, None], sdt[:, t, :, None]
                dtx = dtt * xt
                da = torch.exp(dtt * av)
                h = h * da + dtx * sb[:, t, None, :]
                acc = lane_tree(lane_sums(h * sc[:, t, None, :], lanes),
                                lanes)
                yt = acc[..., 0] + dd * xt[..., 0]
                y[:, t0 + t, cols[live]] = yt[:, live]
        h_out[:, cols[live]] = h[:, live, :n]
    return (y, h_out, chunks) if chunk_states else (y, h_out)


def ordered_sum(terms):
    """terms[0] + terms[1] + ... one rounded add at a time, in order."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def replay_bwd(x, dt, bm, cm, a, d_skip, dy, block_order=None):
    """(dx, ddt, dB, dC, dA, dD) of the backward kernel's schedule (see the
    module docstring), from ``replay``'s chunk states.  ``block_order``:
    the order the blocks of channels run in (the result must not depend
    on it)."""
    b, s, di = x.shape
    n = bm.shape[-1]
    lanes, ch = geometry(n)
    nmax = lanes * SPL
    heads = a.dim() == 1
    nh = a.shape[0] if heads else 0
    hd = di // nh if heads else 1
    _, _, chunks = replay(x, dt, bm, cm, a, d_skip, chunk_states=True)
    dtc, ac, dc_ = per_channel(dt, a, d_skip, di) if heads else (dt, a,
                                                                 d_skip)
    nblk = -(-di // ch)
    nchunks = chunks.shape[1]
    dx, ddt_c = torch.zeros((b, s, di)), torch.zeros((b, s, di))
    pdb = torch.zeros((b, s, nblk, n))
    pdc = torch.zeros((b, s, nblk, n))
    pda = torch.zeros((b, di, n))       # per channel (mamba1)
    dah_c, ddc_c = torch.zeros((b, di)), torch.zeros((b, di))
    for blk in (block_order or range(nblk)):
        c0 = blk * ch
        live = torch.arange(c0, c0 + ch) < di
        cols = torch.arange(c0, c0 + ch).clamp(max=di - 1)
        av = torch.zeros((ch, nmax))
        if not heads:
            av[:, :n] = ac[cols]
        av[~live] = 0.0
        ah = torch.where(live, ac[cols, 0], torch.zeros(())) if heads \
            else None
        dd = torch.where(live, dc_[cols], torch.zeros(()))
        g = torch.zeros((b, ch, nmax))
        dacc = torch.zeros((b, ch, nmax))
        dah, ddc = torch.zeros((b, ch)), torch.zeros((b, ch))
        for k in reversed(range(nchunks)):
            t0 = k * TCHUNK
            tn = min(TCHUNK, s - t0)
            sx = staged(b, TCHUNK, ch, live, cols, x, t0, tn)
            sdy = staged(b, TCHUNK, ch, live, cols, dy, t0, tn)
            sdt = staged(b, TCHUNK, ch, live, cols, dtc, t0, tn)
            sb = torch.zeros((b, TCHUNK, nmax))
            sc = torch.zeros((b, TCHUNK, nmax))
            sb[:, :tn, :n] = bm[:, t0:t0 + tn]
            sc[:, :tn, :n] = cm[:, t0:t0 + tn]
            hst = torch.zeros((b, ch, nmax))
            hst[:, live, :n] = chunks[:, k, cols[live]]
            # replay, keeping every step's h
            hs, h = [], hst
            for t in range(tn):
                dtt = sdt[:, t, :, None]
                da = torch.exp(dtt * (ah[:, None] if heads else av))
                h = h * da + (dtt * sx[:, t, :, None]) * sb[:, t, None, :]
                hs.append(h)
            for t in range(tn):       # dC: the block's channels in order
                pdc[:, t0 + t, blk] = ordered_sum(
                    [sdy[:, t, q, None] * hs[t][:, q] for q in range(ch)]
                )[:, :n]
            dbt = [None] * tn
            for t in reversed(range(tn)):
                xt, dyt = sx[:, t, :, None], sdy[:, t, :, None]
                dtt = sdt[:, t, :, None]
                hp = hs[t - 1] if t > 0 else hst
                gj = g + dyt * sc[:, t, None, :]
                gb = lane_tree(lane_sums(gj * sb[:, t, None, :], lanes),
                               lanes)[..., 0]
                if heads:
                    da = torch.exp(dtt * ah[:, None])
                    qa = lane_tree(lane_sums(gj * hp, lanes), lanes)[..., 0]
                    gz = qa * da[..., 0]
                    dtcn = gb * xt[..., 0] + gz * ah
                    dah = dah + gz * dtt[..., 0]
                else:
                    da = torch.exp(dtt * av)
                    gz = (gj * hp) * da
                    qa = lane_tree(lane_sums(gz * av, lanes), lanes)[..., 0]
                    dacc = dacc + gz * dtt
                    dtcn = gb * xt[..., 0] + qa
                dbt[t] = gj * (dtt * xt)
                g = gj * da
                dx[:, t0 + t, cols[live]] = (gb * dtt[..., 0]
                                             + dd * dyt[..., 0])[:, live]
                ddt_c[:, t0 + t, cols[live]] = dtcn[:, live]
                ddc = ddc + dyt[..., 0] * xt[..., 0]
            for t in range(tn):       # dB: the block's channels in order
                pdb[:, t0 + t, blk] = ordered_sum(
                    [dbt[t][:, q] for q in range(ch)])[:, :n]
        pda[:, cols[live]] = dacc[:, live, :n]
        dah_c[:, cols[live]] = dah[:, live]
        ddc_c[:, cols[live]] = ddc[:, live]
    d_b = ordered_sum([pdb[:, :, k] for k in range(nblk)])
    d_c = ordered_sum([pdc[:, :, k] for k in range(nblk)])
    if not heads:
        return (dx, ddt_c, d_b, d_c, ordered_sum(list(pda)),
                ordered_sum(list(ddc_c)))
    # per head: a head's channels in a block in order, then (ddt) its
    # blocks in order, (dA, dD) the rows, then its blocks, in order
    bph = hd // ch if hd > ch else 1
    part = []                    # (head, block within head) -> channels
    for h_ in range(nh):
        for kin in range(bph):
            lo = h_ * hd + kin * (hd // bph)
            part.append(range(lo, lo + hd // bph))
    ddt = torch.stack([ordered_sum([ordered_sum(
        [ddt_c[..., c] for c in part[h_ * bph + kin]])
        for kin in range(bph)]) for h_ in range(nh)], -1)
    reds = []
    for vals in (dah_c, ddc_c):
        reds.append(torch.stack([ordered_sum([ordered_sum(
            [vals[r, c] for c in part[h_ * bph + kin]])
            for r in range(b) for kin in range(bph)]) for h_ in range(nh)]))
    return dx, ddt, d_b, d_c, reds[0], reds[1]


def _inputs(b, s, di, n, seed=17):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, di)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)) - 1.0)
                  ).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    a = -np.exp(rng.standard_normal((di, n)) * 0.3).astype(np.float32)
    d = rng.standard_normal(di).astype(np.float32)
    return x, dt, bm, cm, a, d


@pytest.mark.parametrize("di", [100, 136])
@pytest.mark.parametrize("n", [1, 5, 8, 16])
def test_replay_matches_plain(n, di):
    args = [torch.from_numpy(t) for t in _inputs(2, 37, di, n)]
    yr, hr = replay(*args)
    yp, hp = tscan.selective_scan_plain(*args)
    assert torch.equal(hr, hp)
    assert (yr - yp).abs().max() <= 1e-5 * yp.abs().max()


@pytest.mark.parametrize("n", [1, 5, 8, 16])
def test_replay_matches_pallas(n):
    """di = 136 with block_d = 68, which divides it (the Pallas kernel
    asserts di % block_d == 0); the replay's blocks are 64 channels."""
    args = _inputs(2, 37, 136, n, seed=23)
    yk, hk = selective_scan_pallas(*(jnp.asarray(t) for t in args),
                                   block_d=68, interpret=True)
    yr, hr = replay(*(torch.from_numpy(t) for t in args))
    np.testing.assert_allclose(yr.numpy(), np.asarray(yk), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(hr.numpy(), np.asarray(hk), rtol=1e-4,
                               atol=1e-5)


def test_replay_blocks_and_chunks_do_not_change_the_bits():
    """The block width and chunk length move only where values are
    staged: the kernel's schedule gives the same bits at other sizes, so a
    sweep of the kernel's CHANNELS and TCHUNK keeps its results."""
    args = [torch.from_numpy(t) for t in _inputs(1, 37, 100, 16, seed=29)]
    y0, h0 = replay(*args)
    for channels, tchunk in ((32, 8), (128, 32), (8, 37)):
        y1, h1 = replay(*args, channels=channels, tchunk=tchunk)
        assert torch.equal(y0, y1) and torch.equal(h0, h1)


def _head_inputs(b, s, nh, hd, n, seed=31):
    """A per-head call's inputs: x [b, s, nh hd], dt [b, s, nh], A, D
    [nh]."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, nh * hd)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)) - 1.0)
                  ).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    a = -np.exp(rng.standard_normal(nh) * 0.3).astype(np.float32)
    d = rng.standard_normal(nh).astype(np.float32)
    return x, dt, bm, cm, a, d


@pytest.mark.parametrize("di", [100, 136])
@pytest.mark.parametrize("n", [17, 40, 64])
def test_widened_replay_matches_plain(n, di):
    """16 lanes a channel, 16 channels a block: h bit for bit, y within
    1e-5 of max |y|."""
    args = [torch.from_numpy(t) for t in _inputs(2, 37, di, n)]
    yr, hr = replay(*args)
    yp, hp = tscan.selective_scan_plain(*args)
    assert torch.equal(hr, hp)
    assert (yr - yp).abs().max() <= 1e-5 * yp.abs().max()


@pytest.mark.parametrize("n,nh,hd", [(8, 8, 32), (8, 3, 8), (64, 4, 64),
                                     (64, 5, 16), (40, 2, 8)])
def test_heads_replay_matches_plain(n, nh, hd):
    """The per-head variant (zamba2's 64 states and head dim 64, the
    reduced config's 8 and 32, heads narrower than a block and di not a
    multiple of it): h bit for bit with ``selective_scan_heads_ref``, y
    within 1e-5 of max |y|."""
    args = [torch.from_numpy(t) for t in _head_inputs(2, 37, nh, hd, n)]
    yr, hr = replay(*args)
    yp, hp = tscan.selective_scan_plain(*args)
    assert torch.equal(hr, hp)
    assert (yr - yp).abs().max() <= 1e-5 * yp.abs().max()


def test_widened_replay_matches_pallas():
    """64 states a channel against ``selective_scan_pallas`` (interpret,
    block_d 68), the reference's tolerance."""
    args = _inputs(1, 21, 136, 64, seed=37)
    yk, hk = selective_scan_pallas(*(jnp.asarray(t) for t in args),
                                   block_d=68, interpret=True)
    yr, hr = replay(*(torch.from_numpy(t) for t in args))
    np.testing.assert_allclose(yr.numpy(), np.asarray(yk), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(hr.numpy(), np.asarray(hk), rtol=1e-4,
                               atol=1e-5)


BWD_CASES = [("chan", 5, 100, 0), ("chan", 16, 136, 0), ("chan", 64, 40, 0),
             ("heads", 8, 32, 8), ("heads", 64, 64, 3), ("heads", 8, 128, 2),
             ("heads", 64, 8, 5)]


def _bwd_args(kind, n, width, count, seed=41):
    """(x, dt, B, C, A, D, dy): per channel di = ``width``; per head
    ``count`` heads of ``width`` channels."""
    if kind == "chan":
        args = _inputs(2, 37, width, n, seed=seed)
        di = width
    else:
        args = _head_inputs(2, 37, count, width, n, seed=seed)
        di = count * width
    dy = np.random.default_rng(seed + 1).standard_normal(
        (2, 37, di)).astype(np.float32)
    return [torch.from_numpy(t) for t in args + (dy,)]


@pytest.mark.parametrize("kind,n,width,count", BWD_CASES)
def test_replay_bwd_matches_plain(kind, n, width, count):
    """The backward's schedule against autograd through the plain version:
    every gradient within 1e-5 of its largest entry.  Cases: per channel
    at 5, 16 and 64 states (4 and 16 lanes; di not a multiple of a block);
    per head at the reduced zamba2's 8 states and head dim 32 (two heads a
    block), zamba2's 64 states and head dim 64 (a head over 4 blocks), a
    head dim 128 over two 64-channel blocks and head dim 8 (two heads in a
    16-channel block)."""
    args = _bwd_args(kind, n, width, count)
    got = replay_bwd(*args)
    want = tscan.selective_scan_bwd_plain(*args)
    for name, g, w in zip(("dx", "ddt", "dB", "dC", "dA", "dD"), got, want):
        assert g.shape == w.shape, name
        assert (g - w).abs().max() <= 1e-5 * w.abs().max(), name


@pytest.mark.parametrize("kind,n,width,count", [BWD_CASES[1], BWD_CASES[4]])
def test_replay_bwd_order_is_fixed(kind, n, width, count):
    """The blocks' partials are summed by index, so the gradients keep
    their bits whatever order the blocks run in (on the card, whatever
    the SM count)."""
    args = _bwd_args(kind, n, width, count, seed=43)
    lanes, ch = geometry(n)
    nblk = -(-args[0].shape[-1] // ch)
    a = replay_bwd(*args)
    b = replay_bwd(*args, block_order=list(reversed(range(nblk))))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
