"""Selective scan, forward and backward: CUDA kernels + plain versions.

``selective_scan`` replaces ``selective_scan_pallas`` (_scan_kernel) of
``src/repro/kernels/selective_scan.py``.  ``selective_scan_bwd`` replaces
no TPU kernel: the reference trains both SSM block types by
differentiating ``lax.scan`` (``src/repro/models/blocks.py`` mamba1_apply
and mamba2_apply), and the port's training path needs the gradient as a
kernel.  Kernel source: ``repro_torch/csrc/selective_scan.cu``.

Function: per step ``h = h * exp(dt A) + (dt x) B`` and ``y = h.C + D x``;
returns (y [B, S, di], the final h [B, di, n]), all f32.  Two variants,
told apart by A's rank:

* Mamba-1, per channel: x, dt [B, S, di]; B, C [B, S, n]; A [di, n]; D
  [di] (the TPU kernel's function);
* Mamba-2, per head: x [B, S, nh * hd]; dt [B, S, nh]; B, C [B, S, n]; A,
  D [nh], each head's dt, A and D shared by its hd channels (h [B, di, n]
  is the [B, nh, hd, n] state of reference blocks.py:724-729).

Bound on the card: bytes (x, dt and y stream once; the state stays on
chip).  Design: a channel's states split over 4 lanes of a warp at n <= 16
and over 16 lanes at n <= 64, 4 states each in registers, the lanes'
shares of h.C summed by a fixed shuffle tree; blocks of 256 threads (64 or
16 channels) of one row; chunks of 16 timesteps staged in shared memory
with cp.async, double-buffered; per head one exp a (step, head).  The
backward replays each chunk from the state the forward saved at its start
and walks it backwards; its sums across channels, rows and steps are
per-block partials summed in a fixed order (no float atomics).

``SelectiveScanFn`` is the autograd Function over both variants; on the
CPU it runs the plain forward and, for the backward, autograd through the
plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, kernel_entry, plain_version, ref
from repro_torch.kernels.s2fp8_quant import check_cuda_operand

MAX_STATE = 64
TCHUNK = 16                     # the kernels' chunk of steps (chunk states)


def block_channels(n: int) -> int:
    """Channels a block of the kernels covers at ``n`` states: 256 threads
    of 4 lanes a channel at n <= 16, of 16 lanes above."""
    return 64 if n <= 16 else 16


def _check_shapes(x, dt, bmat, cmat, a, d_skip) -> None:
    """Per channel (A [di, n]) or per head (A [nh]); raises on anything
    else."""
    if x.dim() != 3:
        raise ValueError(f"selective_scan wants x [B, S, di]; got "
                         f"{tuple(x.shape)}")
    b, s, di = x.shape
    n = bmat.shape[-1]
    if bmat.shape != (b, s, n) or cmat.shape != (b, s, n):
        raise ValueError(f"selective_scan wants B, C [{b}, {s}, n]; got "
                         f"{tuple(bmat.shape)}, {tuple(cmat.shape)}")
    if a.dim() == 1:
        nh = a.shape[0]
        if (nh < 1 or di % nh or dt.shape != (b, s, nh)
                or d_skip.shape != (nh,)):
            raise ValueError(
                f"per-head selective_scan wants dt [{b}, {s}, nh], A and D "
                f"[nh] with nh dividing di {di}; got dt {tuple(dt.shape)}, "
                f"A {tuple(a.shape)}, D {tuple(d_skip.shape)}")
        return
    if dt.shape != x.shape:
        raise ValueError(f"selective_scan wants x, dt [B, S, di]; got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}")
    if a.shape != (di, n) or d_skip.shape != (di,):
        raise ValueError(f"selective_scan wants A [{di}, {n}] and D [{di}]; "
                         f"got {tuple(a.shape)}, {tuple(d_skip.shape)}")


def _oracle(a):
    return ref.selective_scan_heads_ref if a.dim() == 1 \
        else ref.selective_scan_ref


@plain_version
def selective_scan_plain(x, dt, bmat, cmat, a, d_skip
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``ref.selective_scan_ref`` (per channel) or
    ``ref.selective_scan_heads_ref`` (per head), the kernel's recurrence
    step by step in f32, each multiply and add rounded alone as the kernel
    rounds them (only the sum over n may run in another order)."""
    _check_shapes(x, dt, bmat, cmat, a, d_skip)
    return _oracle(a)(x, dt, bmat, cmat, a, d_skip)


def _check_cuda(x, dt, bmat, cmat, a, d_skip, *more) -> None:
    for name, t in (("x", x), ("dt", dt), ("B", bmat), ("C", cmat),
                    ("A", a), ("D", d_skip)) + more:
        check_cuda_operand(t, name, (torch.float32,), x.device)
    n = bmat.shape[-1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan kernel takes 1..{MAX_STATE} "
                         f"states, got {n}")


@kernel_entry("selective_scan")
def selective_scan(x, dt, bmat, cmat, a, d_skip, chunk_states: bool = False):
    """(y f32 [B, S, di], h f32 [B, di, n]) of the selective scan, per
    channel or per head (see the module docstring); every input f32 and
    contiguous on one CUDA device, n <= 64.  With ``chunk_states`` a third
    result: the state at the start of every ``TCHUNK``-step chunk [B,
    ceil(S / TCHUNK), di, n], which ``selective_scan_bwd`` replays from
    (None from the plain version, whose backward needs none).  CPU tensors
    take the plain version."""
    _check_shapes(x, dt, bmat, cmat, a, d_skip)
    if x.device.type == "cpu":
        y, h = selective_scan_plain(x, dt, bmat, cmat, a, d_skip)
        return (y, h, None) if chunk_states else (y, h)
    _check_cuda(x, dt, bmat, cmat, a, d_skip)
    b, s, di = x.shape
    n = bmat.shape[-1]
    nh = a.shape[0] if a.dim() == 1 else 0
    y = torch.empty_like(x)
    h = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    chunks = (torch.empty((b, -(-s // TCHUNK), di, n), dtype=torch.float32,
                          device=x.device) if chunk_states else None)
    rc = build.load("selective_scan").selective_scan(
        x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        a.data_ptr(), d_skip.data_ptr(), y.data_ptr(), h.data_ptr(),
        build.ptr(chunks), b, s, di, n, nh, build.stream_ptr(x.device))
    build.check(rc, "selective_scan")
    selective_scan.launches += 1
    return (y, h, chunks) if chunk_states else (y, h)


selective_scan.launches = 0


@plain_version
def selective_scan_bwd_plain(x, dt, bmat, cmat, a, d_skip, dy,
                             chunks: Optional[torch.Tensor] = None):
    """Plain version of the backward: autograd through the plain forward
    (``ref.selective_scan_ref`` / ``selective_scan_heads_ref``) for the
    cotangent ``dy`` of y -> (dx, ddt, dB, dC, dA, dD), each of its
    input's shape.  ``chunks`` is not read."""
    _check_shapes(x, dt, bmat, cmat, a, d_skip)
    with torch.enable_grad():
        ins = [t.detach().float().requires_grad_()
               for t in (x, dt, bmat, cmat, a, d_skip)]
        y, _ = _oracle(a)(*ins)
        return torch.autograd.grad(y, ins, dy.float())


@kernel_entry("selective_scan_bwd")
def selective_scan_bwd(x, dt, bmat, cmat, a, d_skip, dy,
                       chunks: Optional[torch.Tensor]):
    """(dx, ddt, dB, dC, dA, dD) of y = ``selective_scan(x, dt, B, C, A,
    D)[0]`` for the cotangent ``dy`` [B, S, di], from the forward's chunk
    states ``chunks``.  Every input f32 and contiguous on one CUDA device;
    per head, the head dim must divide the kernel's block of channels (64 at
    n <= 16, 16 above) or be a multiple of it.  CPU tensors take the plain
    version."""
    _check_shapes(x, dt, bmat, cmat, a, d_skip)
    if x.device.type == "cpu":
        return selective_scan_bwd_plain(x, dt, bmat, cmat, a, d_skip, dy)
    b, s, di = x.shape
    n = bmat.shape[-1]
    _check_cuda(x, dt, bmat, cmat, a, d_skip, ("dy", dy), ("chunks", chunks))
    if dy.shape != x.shape or chunks.shape != (b, -(-s // TCHUNK), di, n):
        raise ValueError(f"selective_scan_bwd wants dy {tuple(x.shape)} and "
                         f"chunk states [{b}, {-(-s // TCHUNK)}, {di}, {n}]; "
                         f"got {tuple(dy.shape)}, {tuple(chunks.shape)}")
    nh = a.shape[0] if a.dim() == 1 else 0
    if nh:
        hd, ch = di // nh, block_channels(n)
        if hd % ch and ch % hd:
            raise ValueError(f"selective_scan_bwd takes a head dim that "
                             f"divides {ch} or is a multiple of it; got {hd}")
    lib = build.load("selective_scan")
    floats = lib.selective_scan_bwd_scratch(b, s, di, n, nh)
    if floats < 0:
        raise ValueError("selective_scan_bwd: scratch above 2^31 floats")
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    grads = [torch.empty_like(t) for t in (x, dt, bmat, cmat, a, d_skip)]
    rc = lib.selective_scan_bwd(
        x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        a.data_ptr(), d_skip.data_ptr(), dy.data_ptr(), chunks.data_ptr(),
        *(g.data_ptr() for g in grads), scratch.data_ptr(), b, s, di, n, nh,
        build.stream_ptr(x.device))
    build.check(rc, "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    return tuple(grads)


selective_scan_bwd.launches = 0


class SelectiveScanFn(torch.autograd.Function):
    """y = selective_scan(x, dt, B, C, A, D)[0], differentiable in all six
    inputs, per channel or per head.  The forward saves its inputs and the
    chunk states; the backward is ``selective_scan_bwd``."""

    @staticmethod
    def forward(ctx, x, dt, bmat, cmat, a, d_skip):
        args = [t.contiguous() for t in (x, dt, bmat, cmat, a, d_skip)]
        y, _, chunks = selective_scan(*args, chunk_states=True)
        ctx.save_for_backward(*args, chunks)
        return y

    @staticmethod
    def backward(ctx, dy):
        *args, chunks = ctx.saved_tensors
        return selective_scan_bwd(*args, dy.contiguous(), chunks)
