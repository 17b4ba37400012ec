"""Paged S2FP8 decode attention: CUDA kernel + plain version.

``paged_decode_attention`` replaces the Pallas kernel of the same name
(_paged_kernel) in ``src/repro/kernels/paged_attention.py``.  Kernel
source: ``repro_torch/csrc/paged_attention.cu``.

Bound on the card: bytes — each slot's live K/V payload rows, read once.
Design: a split-KV decode in one launch, one block per (KV head, slot,
split of :data:`SPLIT` cache positions); a split past the slot's position
exits at once, and a block reads its own ``table[slot, j]`` (Hopper has no
scalar prefetch).  Lane groups of hd / 16 lanes, rounded up to a power of
two (the extra lanes idle), read payload rows as 16-byte loads,
dequantize through 256-entry tables in shared memory, share each K/V row
among the KV head's query rows (up to 4 a block) and keep an online
softmax in registers; warps merge in a fixed order, each split writes
(m, l, acc) to a scratch tensor, and the slot's last split to finish
(an integer ticket) merges the splits in split order.  No float atomics,
and the split is a constant of the kernel, so the bits do not depend on
the card.

The math is the reference kernel's: a plain f32 softmax over dequantized
K/V, with no truncation of q, logits, probabilities or output (the JAX
``ref`` engine's decode differs; see ROADMAP queue 3).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.core import s2fp8
from repro_torch.kernels import build, kernel_entry, plain_version, ref
from repro_torch.kernels.s2fp8_quant import (FMT_ID, check_cuda_operand,
                                             stats_arg)

_MASK_VALUE = -1e30
# cache positions one block of the kernel covers (kSplit in the source,
# which refuses any other value)
SPLIT = 256
HEAD_DIMS = tuple(range(16, 257, 16))   # every multiple of 16 up to 256


def _check_shapes(q, kp, vp, table, positions):
    if q.dim() != 4 or kp.dim() != 4 or kp.shape != vp.shape:
        raise ValueError(f"paged decode wants q [B,KV,G,hd] and pools "
                         f"[nb,KV,blk,hd]; got {tuple(q.shape)}, "
                         f"{tuple(kp.shape)}, {tuple(vp.shape)}")
    b, kvh, _, hd = q.shape
    if (kp.shape[1], kp.shape[3]) != (kvh, hd):
        raise ValueError(f"pool {tuple(kp.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if table.dim() != 2 or table.shape[0] != b or positions.shape != (b,):
        raise ValueError(f"table {tuple(table.shape)} / positions "
                         f"{tuple(positions.shape)} do not match {b} slots")


@plain_version
def paged_decode_plain(q, kp, vp, k_ab, v_ab, table, positions,
                       fmt: str = "e5m2"):
    """Plain version: gather + dequantize + masked softmax, an op-for-op port
    of ``paged_decode_reference``."""
    _check_shapes(q, kp, vp, table, positions)
    b, kvh, g, hd = q.shape
    blk = kp.shape[2]
    max_b = table.shape[1]
    idx = table.long()

    def gathered(pool):
        u8 = pool.view(torch.uint8)[idx]          # [B, max_b, KV, blk, hd]
        u8 = u8.movedim(1, 2).reshape(b, kvh, max_b * blk, hd)
        return u8.view(pool.dtype)

    kf = ref.s2fp8_dequant_ref(gathered(kp), k_ab)
    vf = ref.s2fp8_dequant_ref(gathered(vp), v_ab)
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), kf)
    s = s / math.sqrt(hd)
    kpos = torch.arange(max_b * blk, device=q.device)
    mask = kpos[None, :] <= positions.long()[:, None]         # [B, S]
    s = torch.where(mask[:, None, None, :], s, _MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bksd->bkgd", p, vf)


_TICKETS = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 tickets (the kernel takes one per slot,
    KV head and chunk of query rows), one buffer per device and stream,
    kept: the kernel leaves every ticket it takes at zero, so launches in
    one stream's order can share it."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


@functools.lru_cache(maxsize=None)
def _inv_sqrt(hd: int) -> float:
    """1 / sqrt(hd) rounded to f32, as the kernel's score scale."""
    return float(torch.tensor(1.0) / torch.sqrt(torch.tensor(float(hd))))


@kernel_entry("paged_decode")
def paged_decode_attention(q, kp, vp, k_ab, v_ab, table, positions,
                           fmt: str = "e5m2"):
    """q: [B, KV, G, hd] f32; kp/vp: [n_blocks, KV, block, hd] float8 pools;
    table: [B, max_blocks] int32 (0 = trash block); positions: [B] int32.
    Returns [B, KV, G, hd] f32.  CPU tensors take the plain version."""
    _check_shapes(q, kp, vp, table, positions)
    if q.device.type == "cpu":
        return paged_decode_plain(q, kp, vp, k_ab, v_ab, table, positions,
                                  fmt)
    dev = q.device
    check_cuda_operand(q, "q", (torch.float32,))
    for name, t in (("kp", kp), ("vp", vp)):
        check_cuda_operand(t, name, (s2fp8.FMT_QDTYPE[fmt],), dev)
    check_cuda_operand(table, "table", (torch.int32,), dev)
    check_cuda_operand(positions, "positions", (torch.int32,), dev)
    b, kvh, g, hd = q.shape
    blk, max_b = kp.shape[2], table.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged decode kernel takes head dims that are "
                         f"multiples of 16 in 16..256, got {hd}")
    for name, t in (("kp", kp), ("vp", vp)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    kab, vab = stats_arg(k_ab, dev), stats_arg(v_ab, dev)
    out = torch.empty_like(q)
    nsplit = -(-max_b * blk // SPLIT)
    scratch = torch.empty(b * kvh * nsplit * g * (hd + 2),
                          dtype=torch.float32, device=dev)
    stream = build.stream_ptr(dev)
    tickets = _tickets(dev, stream, b * kvh * g)
    rc = build.load("paged_attention").s2fp8_paged_decode(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
        positions.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        scratch.numel(), tickets.data_ptr(), tickets.numel(), b, kvh, g, hd,
        blk, max_b, kab.data_ptr(), vab.data_ptr(), _inv_sqrt(hd),
        FMT_ID[fmt], SPLIT, stream)
    build.check(rc, "s2fp8_paged_decode")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
