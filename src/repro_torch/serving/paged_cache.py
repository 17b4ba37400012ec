"""Paged S2FP8 KV cache: fixed-size blocks, a block table, and a host
free-list allocator (port of ``repro.serving.paged_cache``).

Layout per attention segment::

    kp / vp : [L, n_blocks, KV, block, hd]   pool (payload or f32)
    kab/vab : [L, 2]                          frozen (alpha, beta) per layer
    table   : [slots, max_blocks] int32       block table

The reference duplicates ``table`` per layer so it rides the layer scan;
the port loops over layers in Python, so one table serves them all.
Pools are updated in place (the reference returns updated copies), which
keeps one pool in memory.  Block 0 is the trash block: never allocated,
the target of every dead-slot and dummy-row write; the pool starts at zero
and encodes clamp at the format's max, so every value it can hold is
finite.

``cache_fmt`` (the reference's five):

    "e5m2" / "e4m3"         : 8-bit payload pool (the serving engine)
    "f32_e5m2" / "f32_e4m3" : f32 pool of grid-snapped values, the parity
        comparator: the truncate-apply kernel writes Eq. 5 as lut[code],
        so an f32_{fmt} pool holds dequant(quant_apply(x)) of the {fmt}
        pool bit for bit, and both engines decode the same greedy tokens
    "f32"                   : raw f32, no truncation (the fp32 baseline on
        the same paged structure)

Encodes run through the policy's engine (quantize-apply or truncate-apply
under the frozen stats: the kernels on ``cuda``, their plain versions on
``plain``), so pack-time and decode-time writes are the same program.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import backend as nbackend
from repro_torch.core import s2fp8, statsbank
from repro_torch.core.s2fp8 import S2FP8Tensor
from repro_torch.kernels import paged_attention as _pk

CACHE_FMTS = ("e5m2", "e4m3", "f32_e5m2", "f32_e4m3", "f32")
# Segment block types that use the paged KV layout (global attention only;
# sliding-window rings and mamba conv / ssm states keep their dense layout)
PAGED_BLOCK_TYPES = ("dense", "moe", "attn", "dense_first")


def _check_fmt(cache_fmt: str) -> None:
    if cache_fmt not in CACHE_FMTS:
        raise ValueError(f"unknown cache format {cache_fmt!r}; want one of "
                         f"{CACHE_FMTS}")


def base_fmt(cache_fmt: str) -> Optional[str]:
    """The fp8 grid a cache format snaps to (None for raw f32)."""
    if cache_fmt == "f32":
        return None
    return cache_fmt.split("_")[-1]


def is_payload(cache_fmt: str) -> bool:
    return cache_fmt in ("e5m2", "e4m3")


def pool_dtype(cache_fmt: str) -> torch.dtype:
    if is_payload(cache_fmt):
        return s2fp8.FMT_QDTYPE[cache_fmt]
    return torch.float32


def _check_blocks(cfg: ArchConfig) -> None:
    from repro_torch.models import transformer as tlm
    for i, (btype, _) in enumerate(tlm.segments_of(cfg)):
        if btype not in PAGED_BLOCK_TYPES:
            raise ValueError(f"paged serving supports global-attention "
                             f"blocks only, got {btype!r} (segment {i}); "
                             f"window rings / ssm states need the dense "
                             f"engine")


def _raw(t: torch.Tensor) -> torch.Tensor:
    """A pool or an encoded value as indexable storage: payload bytes as
    uint8 (fp8 tensors take no index writes), f32 as is."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _encode(x: torch.Tensor, stats, cache_fmt: str, backend) -> torch.Tensor:
    """Values -> pool storage (payload bytes, or grid-snapped f32) under
    the frozen (alpha, beta) ``stats``, on the engine ``backend``."""
    fmt = base_fmt(cache_fmt)
    if fmt is None:
        return x.float()
    if is_payload(cache_fmt):
        return backend.quantize(x, stats=stats, fmt=fmt).payload
    return backend.truncate(x.float(), stats=stats, fmt=fmt)


def _decode(g: torch.Tensor, stats, cache_fmt: str, backend) -> torch.Tensor:
    """Pool storage -> f32 values (identity for the f32 pools)."""
    if not is_payload(cache_fmt):
        return g
    return backend.dequantize(S2FP8Tensor(g, stats, cache_fmt))


def identity_stats(n_layers: int, device=None) -> torch.Tensor:
    """[L, 2] (alpha=1, beta=0): the f32 / no-bank configuration."""
    return torch.tensor([1.0, 0.0], device=device).repeat(n_layers, 1)


def kv_stats_from_bank(bank: Dict[str, Any], cfg: ArchConfig,
                       cache_fmt: str) -> List[Tuple[torch.Tensor, ...]]:
    """Per-segment (kab, vab) [L, 2] frozen stats from the bank's
    ``seg{i}:{btype}/kv_cache/t{0,1}`` sites (t0 = K, t1 = V), derived with
    ``statsbank.frozen_stats`` like every other frozen site, for the
    format's grid (e5m2's for raw f32, which ignores them)."""
    from repro_torch.models import transformer as tlm
    _check_blocks(cfg)
    fmt = base_fmt(cache_fmt) or "e5m2"
    out = []
    for i, (btype, length) in enumerate(tlm.segments_of(cfg)):
        abs_ = []
        for t in ("t0", "t1"):
            key = f"seg{i}:{btype}/kv_cache/{t}"
            if key not in bank:
                raise KeyError(f"serving bank has no {key!r} site")
            a, b = statsbank.frozen_stats(bank[key]["fwd"], fmt)
            abs_.append(torch.stack([a, b], dim=-1).contiguous())
        out.append((abs_[0], abs_[1]))
    return out


def init_paged_caches(cfg: ArchConfig, *, slots: int, n_blocks: int,
                      block: int, max_blocks: int, cache_fmt: str,
                      kv_stats=None, device) -> List[Dict[str, torch.Tensor]]:
    """Per-segment paged caches (module docstring has the layout).
    ``kv_stats``: per-segment (kab, vab) from :func:`kv_stats_from_bank`,
    or None for identity stats."""
    from repro_torch.models import transformer as tlm
    _check_fmt(cache_fmt)
    _check_blocks(cfg)
    hd = cfg.resolved_head_dim
    caches = []
    for i, (btype, length) in enumerate(tlm.segments_of(cfg)):
        kab, vab = (kv_stats[i] if kv_stats is not None else
                    (identity_stats(length), identity_stats(length)))
        shape = (length, n_blocks, cfg.kv_heads, block, hd)
        caches.append({
            "kp": _zeros_pool(shape, cache_fmt, device),
            "vp": _zeros_pool(shape, cache_fmt, device),
            "kab": kab.to(device), "vab": vab.to(device),
            "table": torch.zeros((slots, max_blocks), dtype=torch.int32,
                                 device=device),
        })
    return caches


def _zeros_pool(shape, cache_fmt: str, device) -> torch.Tensor:
    if is_payload(cache_fmt):
        return torch.zeros(shape, dtype=torch.uint8, device=device).view(
            pool_dtype(cache_fmt))
    return torch.zeros(shape, dtype=torch.float32, device=device)


def cache_payload_bytes(caches) -> Tuple[int, int]:
    """(pool_bytes, stats_bytes): 1 byte per element of a payload pool (4
    of an f32 one) + the stats scalars."""
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
    A payload pool runs the paged-decode kernel on the ``cuda`` engine and
    its plain version on ``plain`` (the reference's Pallas-engine
    semantics: a plain f32 softmax over the dequantized blocks).  The f32
    pools gather the slot's blocks and attend through
    ``blocks.decode_attention``, as the reference's do on both engines."""
    _check_fmt(cache_fmt)
    kp, vp, table = cache["kp"], cache["vp"], cache["table"]
    _, kvh, blk, hd = kp.shape
    b, max_b = table.shape[0], table.shape[1]
    if qg.shape[0] != b:
        raise ValueError(f"batch {qg.shape[0]} != table slots {b}")
    kst, vst = cache["kab"], cache["vab"]
    be = policy.backend_obj
    ci = cache_index.to(torch.int32)
    bi = torch.arange(b, device=ci.device)
    bid = table[bi, (ci // blk).long()].long()         # [B] current block
    off = (ci % blk).long()
    _raw(kp)[bid, :, off] = _raw(_encode(k[:, :, 0], kst, cache_fmt, be))
    _raw(vp)[bid, :, off] = _raw(_encode(v[:, :, 0], vst, cache_fmt, be))
    if is_payload(cache_fmt):
        q = qg[:, :, :, 0].float().contiguous()
        paged = (_pk.paged_decode_attention
                 if isinstance(be, nbackend.CudaBackend)
                 else _pk.paged_decode_plain)
        out = paged(q, kp, vp, kst, vst, table, ci, fmt=cache_fmt)
        return out[:, :, :, None, :].to(qg.dtype), cache

    from repro_torch.models import blocks as _blocks

    def gathered(pool):
        g = pool[table.long()]                 # [B, max_b, KV, blk, hd]
        return g.transpose(1, 2).reshape(b, kvh, max_b * blk, hd)

    kpos = torch.arange(max_b * blk, device=ci.device)
    valid = kpos[None, :] <= ci[:, None].long()
    attn = _blocks.decode_attention(qg, gathered(kp), gathered(vp), valid,
                                    policy=policy)
    return attn, cache


def pack_dense_caches(paged_caches, dense_caches, bids: torch.Tensor,
                      cache_fmt: str, *, policy):
    """Encode a bucket-width dense prefill cache ({"k","v"} [L, A, KV, P,
    hd]) into the block pools, in place, on the policy's engine.
    ``bids``: [A, P // block] int32 block ids per admitted row; dummy rows
    and blocks past a prompt point at the trash block 0."""
    flat = bids.reshape(-1).long()
    be = policy.backend_obj
    for seg_p, seg_d in zip(paged_caches, dense_caches):
        length, _, kvh, blk, hd = seg_p["kp"].shape
        a_w, nb_p = bids.shape
        for pool_key, dense_key, ab_key in (("kp", "k", "kab"),
                                            ("vp", "v", "vab")):
            pool = _raw(seg_p[pool_key])
            for li in range(length):
                enc = _raw(_encode(seg_d[dense_key][li], seg_p[ab_key][li],
                                   cache_fmt, be))
                enc = enc.reshape(a_w, kvh, nb_p, blk, hd).permute(
                    0, 2, 1, 3, 4).reshape(a_w * nb_p, kvh, blk, hd)
                pool[li][flat] = enc
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
