"""Serving engines (port of ``repro.serving.engine``): the dense-cache
``LMServer`` and the paged-payload ``PayloadLMServer``.

``LMServer`` serves over one dense cache tree at width ``slots`` (f32
leaves: the attention blocks' K/V [L, slots, KV, max_len, hd], a ``local``
block's a ring of ``min(max_len, window)`` positions, the mamba1 and
mamba2 blocks' conv windows and SSM states).  Per tick it
fills every free slot FCFS, runs one prefill per power-of-two prompt
bucket at width ``slots`` (prompts right-padded in their own slot rows,
logits read at each row's true last index) into a fresh cache tree,
copies only the admitted columns into the server's tree, then runs one
decode step for all slots with a per-slot position vector: an attention
block writes each slot's token at its own position (a ``local`` block at
the position mod its ring) and attends over its cache row
(``blocks.decode_attention``, whose two einsums run on the batched payload
GEMM on the payload path).  Prefill and decode use exact per-call stats
(no bank session), as the reference's engine does, so the caches hold K/V
as computed.  As in the reference, a prompt padded to a bucket longer
than a ``local`` block's window leaves the pads' K/V in that block's ring,
and a padded prompt's mamba1 or mamba2 scan and conv window run on through
the pad tokens, so a prompt shorter than its bucket decodes from a state
that includes the pads.

``PayloadLMServer``: KV lives in a paged block pool (serving/paged_cache.py:
S2FP8 payloads, or the f32 comparator pools) with frozen per-layer stats;
every other site's stats come from the frozen bank, so prefill and decode
run no stats reductions.  Per tick:

  * batched, bucketed admission — free slots are filled FCFS from the
    queue while a slot, the prefill-token budget and pool blocks allow;
    admissions are grouped by power-of-two prompt bucket and each bucket
    runs one prefill at fixed width ``admit_width`` (so the set of prefill
    shapes is bounded by the number of buckets), then packs into the pool;
  * block growth at decode boundaries, preempting the youngest live slot
    (LIFO) when the pool runs dry — its request is requeued at the head
    and restarts cleanly;
  * one decode step for all slots with a per-slot position vector;
  * one ``serving_tick`` event to the sink, if one is given.

Both host loops are the reference's, line for line; the device work is
the port's prefill / pack / decode.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import statsbank
from repro_torch.core.policy import Policy
from repro_torch.models import transformer as tlm
from repro_torch.serving import paged_cache


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    out: Optional[List[int]] = None


def _bucket(n: int, lo: int = 1, hi: Optional[int] = None) -> int:
    """Smallest lo * 2**k >= n (capped at hi): the prompt padding bucket."""
    b = lo
    while b < n:
        b *= 2
    return min(b, hi) if hi is not None else b


class LMServer:
    """Slot-batched LM serving over a dense f32 cache tree (see module
    docstring).  The device is the params' device."""

    def __init__(self, cfg: ArchConfig, params, policy: Policy,
                 slots: int = 4, max_len: int = 256, eos: int = -1):
        self.cfg, self.params, self.pol = cfg, params, policy
        self.device = params["embed"].device
        self.slots, self.max_len, self.eos = slots, max_len, eos
        self.caches = tlm.init_caches(cfg, slots, max_len,
                                      device=self.device,
                                      dtype=torch.float32)
        self.slot_pos = np.zeros(slots, np.int32)       # next cache index
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.slot_budget = np.zeros(slots, np.int32)
        self.queue: List[Request] = []
        self.prefill_shapes: set = set()                # (A, P) pairs run
        self._last_token = np.zeros((slots, 1), np.int32)

    # -- device work ------------------------------------------------------
    def _prefill(self, params, tokens, last_index):
        fresh = tlm.init_caches(self.cfg, tokens.shape[0], self.max_len,
                                device=self.device, dtype=torch.float32)
        with torch.no_grad():
            return tlm.prefill(params, tokens, self.cfg, self.pol, fresh,
                               last_index=last_index)

    def _decode(self, params, token, caches, pos):
        with torch.no_grad():
            return tlm.decode_step(params, token, self.cfg, self.pol, caches,
                                   pos)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.out = []
        self.queue.append(req)

    @property
    def max_prefill_shapes(self) -> int:
        """Upper bound on distinct prefill shapes (bucket count)."""
        return int(math.log2(self.max_len)) + 1

    def cache_bytes(self) -> int:
        return sum(v.numel() * v.element_size()
                   for seg in self.caches for v in seg.values())

    def _admit(self):
        """Fill every free slot from the queue, then run one prefill per
        prompt bucket at batch width ``slots`` and merge only the admitted
        columns into the cache tree."""
        adm = []
        for s in range(self.slots):
            if self.slot_req[s] is None and self.queue:
                adm.append((s, self.queue.pop(0)))
        if not adm:
            return
        groups: Dict[int, list] = {}
        for s, req in adm:
            if len(req.prompt) >= self.max_len:
                raise ValueError(f"prompt of {len(req.prompt)} tokens "
                                 f"exceeds max_len {self.max_len}")
            groups.setdefault(
                _bucket(len(req.prompt), hi=self.max_len), []).append((s, req))
        for P, group in sorted(groups.items()):
            toks = np.zeros((self.slots, P), np.int32)
            last = np.zeros((self.slots,), np.int32)
            for s, req in group:
                toks[s, :len(req.prompt)] = req.prompt
                last[s] = len(req.prompt) - 1
            logits, caches = self._prefill(self.params,
                                           self._to_dev(toks).long(),
                                           self._to_dev(last))
            self.prefill_shapes.add((self.slots, P))
            assert len(self.prefill_shapes) <= self.max_prefill_shapes
            cols = self._to_dev(np.asarray([s for s, _ in group])).long()
            for new_seg, old_seg in zip(caches, self.caches):
                for key, new in new_seg.items():
                    if new.dim() >= 2:
                        old_seg[key][:, cols] = new[:, cols]
                    else:
                        old_seg[key] = new
            nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy().astype(
                np.int32)
            for s, req in group:
                self.slot_req[s] = req
                self.slot_pos[s] = len(req.prompt)
                self.slot_budget[s] = req.max_new_tokens
                self._last_token[s, 0] = int(nxt[s])
                req.out.append(int(nxt[s]))
                self.slot_budget[s] -= 1

    def step(self) -> bool:
        """One engine tick: admit, one decode step for all live slots.
        Returns False when idle."""
        self._admit()
        live = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not live:
            return False
        # per-slot position vector: dead slots decode garbage at position 0,
        # discarded here
        pos = np.zeros((self.slots,), np.int32)
        for s in live:
            pos[s] = self.slot_pos[s]
        logits, self.caches = self._decode(
            self.params, self._to_dev(self._last_token).long(), self.caches,
            self._to_dev(pos))
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy().astype(
            np.int32)
        for s in live:
            req = self.slot_req[s]
            req.out.append(int(nxt[s]))
            self._last_token[s, 0] = nxt[s]
            self.slot_pos[s] += 1
            self.slot_budget[s] -= 1
            done = self.slot_budget[s] <= 0 or nxt[s] == self.eos \
                or self.slot_pos[s] >= self.max_len - 1
            if done:
                self.slot_req[s] = None
        return True

    def run_to_completion(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return ticks


class PayloadLMServer:
    """Paged-payload serving engine (see module docstring).

    ``bank``: frozen serving bank (serving/bank.py); None runs without a
    frozen session and with identity cache stats, the fp32-baseline
    configuration.  ``stats_cfg`` is accepted for the reference's
    signature and changes nothing: a frozen session reads no config
    (neither does the reference's).
    ``cache_fmt``: pool storage (paged_cache.CACHE_FMTS): "e5m2" / "e4m3"
    payload pools, "f32_e5m2" / "f32_e4m3" the grid-snapped comparators,
    "f32" the raw baseline.  ``n_blocks``: pool size including the trash
    block; the default leaves no memory pressure (slots * max_blocks + 1).
    ``prefill_token_budget``: per-tick cap on padded prefill tokens.
    ``sink``: an ``obs.sinks`` sink that receives one ``serving_tick``
    event a tick, from host state only.  The device is the params'
    device.
    """

    def __init__(self, cfg: ArchConfig, params, policy: Policy, *,
                 bank: Optional[Dict[str, Any]] = None, slots: int = 8,
                 max_len: int = 256, block: int = 16,
                 n_blocks: Optional[int] = None, cache_fmt: str = "e5m2",
                 eos: int = -1, admit_width: Optional[int] = None,
                 prefill_token_budget: Optional[int] = None,
                 stats_cfg: Optional[statsbank.StatsConfig] = None,
                 sink=None):
        if max_len % block:
            raise ValueError(f"max_len {max_len} not a multiple of "
                             f"block {block}")
        self.cfg, self.params, self.pol = cfg, params, policy
        self.device = params["embed"].device
        self.slots, self.max_len, self.eos = slots, max_len, eos
        self.block = block
        self.max_blocks = max_len // block
        self.n_blocks = n_blocks or slots * self.max_blocks + 1
        self.cache_fmt = cache_fmt
        self.bank = bank
        self.frozen = None if bank is None else statsbank.FrozenBank(bank)
        self.admit_width = admit_width or min(slots, 8)
        self.prefill_token_budget = (prefill_token_budget
                                     or self.admit_width * max_len)
        self.sink = sink

        kv_stats = (None if bank is None else
                    paged_cache.kv_stats_from_bank(bank, cfg, cache_fmt))
        self.caches = paged_cache.init_paged_caches(
            cfg, slots=slots, n_blocks=self.n_blocks, block=block,
            max_blocks=self.max_blocks, cache_fmt=cache_fmt,
            kv_stats=kv_stats, device=self.device)
        self.alloc = paged_cache.BlockAllocator(self.n_blocks, slots,
                                                self.max_blocks)

        self.slot_pos = np.zeros(slots, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.slot_budget = np.zeros(slots, np.int32)
        self.slot_seq = np.zeros(slots, np.int64)       # admission order
        self.queue: List[Request] = []
        self.prefill_shapes: set = set()
        self.preemptions = 0
        self._seq = 0
        self._tick = 0
        self._last_token = np.zeros((slots, 1), np.int32)

    def _session(self):
        """The frozen session over the bank, or none without one."""
        if self.frozen is None:
            return contextlib.nullcontext()
        return statsbank.freeze(self.frozen)

    # -- device work ------------------------------------------------------
    def _prefill(self, params, tokens, last_index):
        dense = tlm.init_caches(self.cfg, tokens.shape[0], tokens.shape[1],
                                device=self.device)
        with torch.no_grad(), self._session():
            return tlm.prefill(params, tokens, self.cfg, self.pol, dense,
                               last_index=last_index)

    def _pack(self, caches, dense, bids):
        with torch.no_grad():
            return paged_cache.pack_dense_caches(caches, dense, bids,
                                                 self.cache_fmt,
                                                 policy=self.pol)

    def _decode(self, params, token, caches, pos):
        with torch.no_grad(), self._session():
            return tlm.decode_step(params, token, self.cfg, self.pol, caches,
                                   pos, cache_fmt=self.cache_fmt)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.out = []
        self.queue.append(req)

    @property
    def max_prefill_shapes(self) -> int:
        return int(math.log2(self.max_len)) + 1

    def cache_bytes(self):
        """(pool_bytes, stats_bytes) of the paged cache."""
        return paged_cache.cache_payload_bytes(self.caches)

    def _sync_tables(self):
        tb = self._to_dev(self.alloc.table)
        for seg in self.caches:
            seg["table"].copy_(tb)

    def _preempt(self, s: int):
        """Release slot s and requeue its request at the queue head."""
        req = self.slot_req[s]
        self.alloc.release(s)
        self.slot_req[s] = None
        if req is not None:
            req.out = []
            self.queue.insert(0, req)
        self.preemptions += 1

    def _pick_victim(self, exclude: int) -> Optional[int]:
        """Youngest live slot other than ``exclude`` (LIFO preemption)."""
        live = [s for s in range(self.slots)
                if s != exclude and self.slot_req[s] is not None]
        return max(live, key=lambda s: self.slot_seq[s]) if live else None

    # ------------------------------------------------------------------
    def _admit(self) -> int:
        free = [s for s in range(self.slots) if self.slot_req[s] is None]
        picked = []
        used = 0
        while self.queue and free and len(picked) < self.admit_width:
            req = self.queue[0]
            plen = len(req.prompt)
            if plen >= self.max_len:
                self.queue.pop(0)
                req.out = []
                continue                             # drop oversize request
            P = _bucket(plen, lo=self.block, hi=self.max_len)
            if picked and used + P > self.prefill_token_budget:
                break                                # token budget: next tick
            s = free[0]
            if not self.alloc.alloc(s, -(-plen // self.block)):
                break                                # pool dry: wait / preempt
            free.pop(0)
            self.queue.pop(0)
            used += P
            self._seq += 1
            self.slot_seq[s] = self._seq
            picked.append((s, req))
        if not picked:
            return 0

        groups: Dict[int, list] = {}
        for s, req in picked:
            groups.setdefault(
                _bucket(len(req.prompt), lo=self.block, hi=self.max_len),
                []).append((s, req))
        A = self.admit_width
        for P, group in sorted(groups.items()):
            toks = np.zeros((A, P), np.int32)
            last = np.zeros((A,), np.int32)
            bids = np.zeros((A, P // self.block), np.int32)  # 0 = trash
            for r, (s, req) in enumerate(group):
                plen = len(req.prompt)
                toks[r, :plen] = req.prompt
                last[r] = plen - 1
                nb = -(-plen // self.block)
                bids[r, :nb] = self.alloc.table[s, :nb]
            logits, dense = self._prefill(self.params,
                                          self._to_dev(toks).long(),
                                          self._to_dev(last))
            self.prefill_shapes.add((A, P))
            assert len(self.prefill_shapes) <= self.max_prefill_shapes
            self.caches = self._pack(self.caches, dense, self._to_dev(bids))
            nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy().astype(
                np.int32)
            for r, (s, req) in enumerate(group):
                self.slot_req[s] = req
                self.slot_pos[s] = len(req.prompt)
                self.slot_budget[s] = req.max_new_tokens
                self._last_token[s, 0] = int(nxt[r])
                req.out.append(int(nxt[r]))
                self.slot_budget[s] -= 1
        return len(picked)

    def step(self) -> bool:
        """One tick: admit, grow blocks at decode boundaries (preempting the
        youngest slot when the pool runs dry), one batched decode."""
        self._tick += 1
        n_admit = self._admit()
        preempted_this_tick = 0
        for s in range(self.slots):
            if self.slot_req[s] is None:
                continue
            need = int(self.slot_pos[s]) // self.block + 1
            while int(self.alloc.nalloc[s]) < need:
                if self.alloc.alloc(s, 1):
                    continue
                victim = self._pick_victim(exclude=s)
                self._preempt(s if victim is None else victim)
                preempted_this_tick += 1
                if self.slot_req[s] is None:
                    break
        live = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not live:
            self._emit_tick(n_admit, 0, preempted_this_tick)
            return bool(n_admit or self.queue)
        self._sync_tables()
        pos = np.zeros((self.slots,), np.int32)
        for s in live:
            pos[s] = self.slot_pos[s]
        logits, self.caches = self._decode(
            self.params, self._to_dev(self._last_token).long(), self.caches,
            self._to_dev(pos))
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy().astype(
            np.int32)
        for s in live:
            req = self.slot_req[s]
            req.out.append(int(nxt[s]))
            self._last_token[s, 0] = nxt[s]
            self.slot_pos[s] += 1
            self.slot_budget[s] -= 1
            done = self.slot_budget[s] <= 0 or nxt[s] == self.eos \
                or self.slot_pos[s] >= self.max_len - 1
            if done:
                self.alloc.release(s)
                self.slot_req[s] = None
        self._emit_tick(n_admit, len(live), preempted_this_tick)
        return True

    def _emit_tick(self, admitted: int, decoded: int, preempted: int):
        """The reference's ``serving_tick`` event, from host state only."""
        if self.sink is None:
            return
        self.sink.emit({
            "kind": "event", "event": "serving_tick", "tick": self._tick,
            "admitted": admitted, "decode_tokens": decoded,
            "preempted": preempted, "preemptions_total": self.preemptions,
            "live": sum(r is not None for r in self.slot_req),
            "queue_depth": len(self.queue),
            "free_blocks": self.alloc.free_blocks,
        })

    def run_to_completion(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        if self.sink is not None:
            self.sink.flush()
        return ticks
