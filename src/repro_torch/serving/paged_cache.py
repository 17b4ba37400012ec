"""Paged S2FP8 KV cache: fixed-size payload blocks, a block table, and a
host free-list allocator (port of ``repro.serving.paged_cache``).

Layout per attention segment::

    kp / vp : [L, n_blocks, KV, block, hd]   8-bit payload pool
    kab/vab : [L, 2]                          frozen (alpha, beta) per layer
    table   : [slots, max_blocks] int32       block table

The reference duplicates ``table`` per layer so it rides the layer scan;
the port loops over layers in Python, so one table serves them all.
Pools are updated in place (the reference returns updated copies), which
keeps one pool in memory.  Block 0 is the trash block: never allocated,
the target of every dead-slot and dummy-row write; the pool starts at zero
and encodes clamp at the format's max, so every value it can hold is
finite.  Only the payload formats ``e5m2`` / ``e4m3`` are ported; the f32
comparator pools wait.  Encoding runs the quantize-apply kernel
(kernels/dispatch.py), so pack-time and decode-time writes are the same
program.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import backend as nbackend
from repro_torch.core import s2fp8, statsbank
from repro_torch.kernels import dispatch
from repro_torch.kernels import paged_attention as _pk

CACHE_FMTS = ("e5m2", "e4m3")
PAGED_BLOCK_TYPES = ("dense",)


def _check_fmt(cache_fmt: str) -> None:
    if cache_fmt not in CACHE_FMTS:
        raise ValueError(f"cache format {cache_fmt!r} is not ported; "
                         f"want one of {CACHE_FMTS}")


def _check_blocks(cfg: ArchConfig) -> None:
    from repro_torch.models import transformer as tlm
    for i, (btype, _) in enumerate(tlm.segments_of(cfg)):
        if btype not in PAGED_BLOCK_TYPES:
            raise ValueError(f"paged serving supports global-attention "
                             f"blocks only, got {btype!r} (segment {i})")


def _u8(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8)


def _encode(x: torch.Tensor, stats, cache_fmt: str) -> torch.Tensor:
    """Values -> pool payload bytes."""
    return dispatch.quant_nd(x, stats, cache_fmt)[0]


def kv_stats_from_bank(bank: Dict[str, Any], cfg: ArchConfig,
                       cache_fmt: str) -> List[Tuple[torch.Tensor, ...]]:
    """Per-segment (kab, vab) [L, 2] frozen stats from the bank's
    ``seg{i}:{btype}/kv_cache/t{0,1}`` sites (t0 = K, t1 = V), derived with
    ``statsbank.frozen_stats`` like every other frozen site."""
    from repro_torch.models import transformer as tlm
    _check_blocks(cfg)
    out = []
    for i, (btype, length) in enumerate(tlm.segments_of(cfg)):
        abs_ = []
        for t in ("t0", "t1"):
            key = f"seg{i}:{btype}/kv_cache/{t}"
            if key not in bank:
                raise KeyError(f"serving bank has no {key!r} site")
            a, b = statsbank.frozen_stats(bank[key]["fwd"], cache_fmt)
            abs_.append(torch.stack([a, b], dim=-1).contiguous())
        out.append((abs_[0], abs_[1]))
    return out


def init_paged_caches(cfg: ArchConfig, *, slots: int, n_blocks: int,
                      block: int, max_blocks: int, cache_fmt: str,
                      kv_stats, device) -> List[Dict[str, torch.Tensor]]:
    """Per-segment paged caches (module docstring has the layout)."""
    from repro_torch.models import transformer as tlm
    _check_fmt(cache_fmt)
    _check_blocks(cfg)
    hd = cfg.resolved_head_dim
    caches = []
    for i, (btype, length) in enumerate(tlm.segments_of(cfg)):
        kab, vab = kv_stats[i]
        shape = (length, n_blocks, cfg.kv_heads, block, hd)
        qdt = s2fp8.FMT_QDTYPE[cache_fmt]
        caches.append({
            "kp": torch.zeros(shape, dtype=torch.uint8, device=device).view(qdt),
            "vp": torch.zeros(shape, dtype=torch.uint8, device=device).view(qdt),
            "kab": kab.to(device), "vab": vab.to(device),
            "table": torch.zeros((slots, max_blocks), dtype=torch.int32,
                                 device=device),
        })
    return caches


def cache_payload_bytes(caches) -> Tuple[int, int]:
    """(pool_bytes, stats_bytes): 1 byte per element + the stats scalars."""
    pool = stats = 0
    for seg in caches:
        for key in ("kp", "vp"):
            pool += seg[key].numel() * seg[key].element_size()
        for key in ("kab", "vab"):
            stats += seg[key].numel() * 4
    return pool, stats


def update_and_attend(qg, k, v, cache, cache_index, *, policy,
                      cache_fmt: str):
    """Write each slot's new K/V token into its current block (in place),
    then attend over the slot's blocks.

    qg: [B, KV, G, 1, hd]; k, v: [B, KV, 1, hd]; ``cache`` is one layer's
    view {kp, vp, kab, vab, table}; ``cache_index``: [B] int32 positions.
    The ``cuda`` engine runs the paged-decode kernel; the ``plain`` engine
    runs its plain version (the reference's Pallas-engine semantics: a
    plain f32 softmax over the dequantized blocks)."""
    _check_fmt(cache_fmt)
    kp, vp, table = cache["kp"], cache["vp"], cache["table"]
    blk = kp.shape[2]
    b = qg.shape[0]
    if table.shape[0] != b:
        raise ValueError(f"batch {b} != table slots {table.shape[0]}")
    kst, vst = cache["kab"], cache["vab"]
    ci = cache_index.to(torch.int32)
    bi = torch.arange(b, device=ci.device)
    bid = table[bi, (ci // blk).long()].long()         # [B] current block
    off = (ci % blk).long()
    _u8(kp)[bid, :, off] = _u8(_encode(k[:, :, 0], kst, cache_fmt))
    _u8(vp)[bid, :, off] = _u8(_encode(v[:, :, 0], vst, cache_fmt))
    q = qg[:, :, :, 0].float().contiguous()
    if isinstance(policy.backend_obj, nbackend.CudaBackend):
        out = _pk.paged_decode_attention(q, kp, vp, kst, vst, table, ci,
                                         fmt=cache_fmt)
    else:
        out = _pk.paged_decode_plain(q, kp, vp, kst, vst, table, ci,
                                     fmt=cache_fmt)
    return out[:, :, :, None, :].to(qg.dtype), cache


def pack_dense_caches(paged_caches, dense_caches, bids: torch.Tensor,
                      cache_fmt: str):
    """Encode a bucket-width dense prefill cache ({"k","v"} [L, A, KV, P,
    hd]) into the block pools, in place.  ``bids``: [A, P // block] int32
    block ids per admitted row; dummy rows and blocks past a prompt point
    at the trash block 0."""
    flat = bids.reshape(-1).long()
    for seg_p, seg_d in zip(paged_caches, dense_caches):
        length, _, kvh, blk, hd = seg_p["kp"].shape
        a_w, nb_p = bids.shape
        for pool_key, dense_key, ab_key in (("kp", "k", "kab"),
                                            ("vp", "v", "vab")):
            pool_u8 = _u8(seg_p[pool_key])
            for li in range(length):
                enc = _u8(_encode(seg_d[dense_key][li], seg_p[ab_key][li],
                                  cache_fmt))
                enc = enc.reshape(a_w, kvh, nb_p, blk, hd).permute(
                    0, 2, 1, 3, 4).reshape(a_w * nb_p, kvh, blk, hd)
                pool_u8[li][flat] = enc
    return paged_caches


class BlockAllocator:
    """Free-list allocator over one pool's blocks (block 0 = trash, never
    handed out).  Pure host/numpy; copied from the reference."""

    def __init__(self, n_blocks: int, slots: int, max_blocks: int):
        self.n_blocks = n_blocks
        self.max_blocks = max_blocks
        self.free: List[int] = list(range(n_blocks - 1, 0, -1))
        self.table = np.zeros((slots, max_blocks), np.int32)
        self.nalloc = np.zeros((slots,), np.int32)

    @property
    def free_blocks(self) -> int:
        return len(self.free)

    def alloc(self, slot: int, n: int) -> bool:
        """Append n blocks to ``slot``; False (nothing allocated) when the
        slot's table or the free list would overflow."""
        have = int(self.nalloc[slot])
        if n <= 0:
            return True
        if have + n > self.max_blocks or n > len(self.free):
            return False
        for i in range(n):
            self.table[slot, have + i] = self.free.pop()
        self.nalloc[slot] = have + n
        return True

    def release(self, slot: int):
        """Return all of ``slot``'s blocks to the free list."""
        for i in range(int(self.nalloc[slot])):
            self.free.append(int(self.table[slot, i]))
        self.table[slot, :] = 0
        self.nalloc[slot] = 0
