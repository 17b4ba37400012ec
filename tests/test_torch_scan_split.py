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

LANES, SPL = 4, 4               # lanes a channel, states a lane
NMAX = LANES * SPL
CHANNELS, TCHUNK = 64, 16       # the kernel's block and chunk


def replay(x, dt, bm, cm, a, d_skip, channels=CHANNELS, tchunk=TCHUNK):
    """(y, h) of the kernel's schedule: every block of ``channels``
    channels of every batch row (batched here), chunk by chunk."""
    b, s, di = x.shape
    n = bm.shape[-1]
    y = torch.full((b, s, di), float("nan"))
    h_out = torch.empty((b, di, n))
    for c0 in range(0, di, channels):
        live = torch.arange(c0, c0 + channels) < di
        cols = torch.arange(c0, c0 + channels).clamp(max=di - 1)
        av = torch.zeros((channels, NMAX))
        av[:, :n] = a[cols]
        av[~live] = 0.0
        dd = torch.where(live, d_skip[cols], torch.zeros(()))
        h = torch.zeros((b, channels, NMAX))
        for t0 in range(0, s, tchunk):
            tn = min(tchunk, s - t0)
            # the staged chunk: zero-filled past di and past S
            sx = torch.zeros((b, tchunk, channels))
            sdt = torch.zeros((b, tchunk, channels))
            sb = torch.zeros((b, tchunk, NMAX))
            sc = torch.zeros((b, tchunk, NMAX))
            sx[:, :tn, live] = x[:, t0:t0 + tn, cols[live]]
            sdt[:, :tn, live] = dt[:, t0:t0 + tn, cols[live]]
            sb[:, :tn, :n] = bm[:, t0:t0 + tn]
            sc[:, :tn, :n] = cm[:, t0:t0 + tn]
            for t in range(tn):
                xt, dtt = sx[:, t, :, None], sdt[:, t, :, None]
                dtx = dtt * xt
                da = torch.exp(dtt * av)
                h = h * da + dtx * sb[:, t, None, :]
                hc = h * sc[:, t, None, :]
                acc = hc[..., torch.arange(LANES) * SPL]
                for j in range(1, SPL):
                    acc = acc + hc[..., torch.arange(LANES) * SPL + j]
                acc = acc + acc[..., [1, 0, 3, 2]]        # xor 1
                acc = acc + acc[..., [2, 3, 0, 1]]        # xor 2
                yt = acc[..., 0] + dd * xt[..., 0]
                y[:, t0 + t, cols[live]] = yt[:, live]
        h_out[:, cols[live]] = h[:, live, :n]
    return y, h_out


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
