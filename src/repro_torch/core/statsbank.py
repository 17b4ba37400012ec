"""StatsBank for the serving slice: per-site S2FP8 statistics, keyed like
the reference's (``repro.core.statsbank``), frozen for serving or
calibrated forward-only.

Bank layout (plain nested dicts, the reference's)::

    bank = {
      "embed/t0":               {"fwd": state, "bwd": state},
      "seg0:dense/attn/qt0":    {"a.fwd": state, ..., "out.bwd": state},
      "seg0:dense/qf0":         {"q.fwd": state, ..., "out.bwd": state},
      "seg0:dense/kv_cache/t0": {"fwd": state, "bwd": state},
      ...
    }
    state = {"alpha", "beta", "ema_mu", "ema_m", "last"}   # f32; [L] rows
                                                           # inside segments

Site keys come from the same naming rules (``scope`` stack, per-prefix
counters, ``seg{i}:{btype}`` segment scope), so a bank exported by the
JAX package loads here unchanged (serving/bank.py ``load_serving_bank``).

The reference scans over layers and traces a segment's body once; the
port runs a Python loop over the layers, so :meth:`Session.segment_ctx`
takes the layer index and restores the naming counters on exit, which
gives every layer the same keys.

Two sessions exist here:

  * :class:`FrozenSession` (``freeze``) — serving: each site serves
    (alpha, beta) re-derived from its carried moments (``frozen_stats``);
    no reductions at all.  :class:`FrozenBank` holds those derived stats
    on the device, computed once per (site, direction, format).
  * :class:`CalibratingSession` (``calibrate``) — the forward-only
    counterpart of a ``bind`` session at step 0 with ``refresh_every=1``:
    every visit refreshes the site's forward states from the tensor it
    sees (``refresh_state``), then uses them (refresh-then-use).  Sites are
    created on first visit.  Cotangent ("bwd") states are never refreshed
    here — nothing in serving reads them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import backend as nbackend
from repro_torch.core import s2fp8

STATE_FIELDS = ("alpha", "beta", "ema_mu", "ema_m", "last")
TRUNC_DIRS = ("fwd", "bwd")
GEMM_DIRS = ("a.fwd", "a.bwd", "b.fwd", "b.bwd", "out.fwd", "out.bwd")
FLASH_DIRS = ("q.fwd", "q.bwd", "k.fwd", "k.bwd", "v.fwd", "v.bwd",
              "out.fwd", "out.bwd")


@dataclasses.dataclass(frozen=True)
class StatsConfig:
    """``refresh_every``: refresh cadence; ``ema_decay``: EMA coefficient
    on the raw (mu, m) moments (0.0 replaces them at each refresh)."""

    refresh_every: int = 16
    ema_decay: float = 0.0

    def __post_init__(self):
        if self.refresh_every < 1:
            raise ValueError("refresh_every must be >= 1")
        if not (0.0 <= self.ema_decay < 1.0):
            raise ValueError("ema_decay must be in [0, 1)")


def init_site_state(length: Optional[int] = None, device=None
                    ) -> Dict[str, torch.Tensor]:
    """Identity stats, empty EMA, ``last = -1`` (bootstrap on first use)."""
    shape = () if length is None else (length,)

    def full(v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    return {"alpha": full(1.0), "beta": full(0.0), "ema_mu": full(0.0),
            "ema_m": full(0.0), "last": full(-1.0)}


def refresh_state(x: torch.Tensor, state: Dict[str, torch.Tensor], step_f,
                  *, ema_decay: float = 0.0,
                  target_max: float = s2fp8.TARGET_MAX_LOG2,
                  backend: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """One refresh: raw moments of ``x`` folded into the EMAs, (alpha, beta)
    re-derived — the reference's rule, op for op."""
    be = nbackend.get_backend(backend)
    log_sum, log_max, count = be.compute_stats_partials(x)
    has = count > 0
    mu_t = log_sum / torch.clamp(count, min=1.0)
    m_t = torch.where(has, log_max, 0.0)
    first = state["last"] < 0
    d = torch.where(first, 0.0, ema_decay)
    ema_mu = torch.where(has, d * state["ema_mu"] + (1.0 - d) * mu_t,
                         state["ema_mu"])
    ema_m = torch.where(has, d * state["ema_m"] + (1.0 - d) * m_t,
                        state["ema_m"])
    valid = torch.logical_or(has, torch.logical_not(first))
    alpha, beta = s2fp8.stats_from_reduction(
        ema_mu, ema_m, torch.where(valid, 1.0, 0.0), target_max)
    new_last = torch.where(has, float(step_f), state["last"])
    return {"alpha": alpha, "beta": beta, "ema_mu": ema_mu, "ema_m": ema_m,
            "last": new_last}


def frozen_stats(state: Dict[str, torch.Tensor], fmt: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha, beta) re-derived from a state's carried raw moments for
    ``fmt``'s target range; never-refreshed sites give identity stats."""
    return s2fp8.stats_from_reduction(
        state["ema_mu"], state["ema_m"], (state["last"] >= 0).float(),
        s2fp8.FMT_TARGET_MAX[fmt])


class FrozenBank:
    """A bank's frozen stats as device tensors: ``stats(key, direction,
    fmt)`` is an f32 [L, 2] (segment sites) or [2] tensor of (alpha, beta),
    derived once and kept."""

    def __init__(self, bank: Dict[str, Any]):
        self.bank = bank
        self._cache: Dict[Tuple[str, str, str], torch.Tensor] = {}

    def stats(self, key: str, direction: str, fmt: str) -> torch.Tensor:
        ck = (key, direction, fmt)
        ab = self._cache.get(ck)
        if ab is None:
            alpha, beta = frozen_stats(self.bank[key][direction], fmt)
            ab = torch.stack([alpha, beta], dim=-1).contiguous()
            self._cache[ck] = ab
        return ab


class Site:
    """One visited site of the active session (a layer's row inside a
    segment).  ``frozen(direction, fmt)`` serves frozen stats;
    ``refresh(direction, x, fmt)`` refreshes a forward state from ``x`` and
    returns the stats to use (calibrating sessions only)."""

    def __init__(self, session: "Session", key: str):
        self.session = session
        self.key = key
        self.layer = session.layer

    def frozen(self, direction: str, fmt: str) -> torch.Tensor:
        ab = self.session.frozen_bank.stats(self.key, direction, fmt)
        return ab if self.layer is None else ab[self.layer]

    def refresh(self, direction: str, x: torch.Tensor, fmt: str,
                backend: Optional[str] = None) -> torch.Tensor:
        return self.session.refresh(self, direction, x, fmt, backend)


class Session:
    """Naming shared by both sessions: scopes, per-prefix counters and
    segment contexts produce the reference's site keys."""

    frozen = False

    def __init__(self, bank: Dict[str, Any], cfg: StatsConfig):
        self.bank = bank
        self.cfg = cfg
        self._scopes: list = []
        self._counters: Dict[str, int] = {}
        self._segment: Optional[Tuple[str, int]] = None
        self._segment_length: Optional[int] = None

    @property
    def layer(self) -> Optional[int]:
        return None if self._segment is None else self._segment[1]

    def _site_key(self, kind: str) -> str:
        prefix = "/".join(self._scopes)
        ckey = f"{prefix}|{kind}"
        n = self._counters.get(ckey, 0)
        self._counters[ckey] = n + 1
        return f"{prefix}/{kind}{n}" if prefix else f"{kind}{n}"

    @contextlib.contextmanager
    def scope(self, name: str):
        self._scopes.append(name)
        try:
            yield
        finally:
            self._scopes.pop()

    def segment_sites(self, name: str, length: int) -> Dict[str, Any]:
        """The bank's entries under segment ``name``, checked to hold one
        row per layer of a ``length``-layer segment."""
        sites = {k: v for k, v in self.bank.items()
                 if k.startswith(name + "/")}
        for key, entry in sites.items():
            for st in entry.values():
                if tuple(st["last"].shape) != (length,):
                    raise ValueError(
                        f"StatsBank site {key!r} holds stats of shape "
                        f"{tuple(st['last'].shape)}, but segment {name!r} "
                        f"has {length} layers")
        self._segment_length = length
        return sites

    @contextlib.contextmanager
    def segment_ctx(self, name: str, layer: int):
        """Serve layer ``layer``'s rows of the sites under ``name``."""
        if self._segment is not None:
            raise RuntimeError("StatsBank segments do not nest")
        saved = dict(self._counters)
        self._segment = (name, layer)
        self._scopes.append(name)
        try:
            yield
        finally:
            self._scopes.pop()
            self._segment = None
            self._counters = saved

    def site(self, kind: str) -> Site:
        key = self._site_key(kind)
        self._require(key, kind)
        return Site(self, key)

    def _require(self, key: str, kind: str) -> None:
        if key not in self.bank:
            raise KeyError(
                f"site {key!r} has no StatsBank entry — the bank does not "
                f"match this model; calibrate or export it again")

    def truncate(self, x: torch.Tensor, *, fmt: str = "e5m2",
                 backend: Optional[str] = None) -> torch.Tensor:
        raise NotImplementedError


class FrozenSession(Session):
    """Read-only serving session: frozen stats at every site, no reductions."""

    frozen = True

    def __init__(self, frozen_bank: FrozenBank):
        super().__init__(frozen_bank.bank, StatsConfig())
        self.frozen_bank = frozen_bank

    def truncate(self, x, *, fmt="e5m2", backend=None):
        ab = self.site("t").frozen("fwd", fmt)
        return nbackend.get_backend(backend).truncate(x, stats=ab, fmt=fmt)


_KIND_DIRS = {"t": TRUNC_DIRS, "qt": GEMM_DIRS, "qf": FLASH_DIRS}


class CalibratingSession(Session):
    """Forward-only calibration: refresh-then-use at every visit, sites
    minted on first visit (``[L]`` rows inside segments)."""

    def __init__(self, bank: Dict[str, Any], cfg: StatsConfig, device):
        if cfg.refresh_every != 1:
            raise ValueError("a calibrating session refreshes at every "
                             "visit: refresh_every must be 1")
        super().__init__(bank, cfg)
        self.device = device

    def _require(self, key, kind):
        if key not in self.bank:
            length = None if self._segment is None else self._segment_length
            self.bank[key] = {d: init_site_state(length, self.device)
                              for d in _KIND_DIRS[kind]}

    def refresh(self, site: Site, direction: str, x: torch.Tensor, fmt: str,
                backend: Optional[str] = None) -> torch.Tensor:
        full = self.bank[site.key][direction]
        state = (full if site.layer is None
                 else {f: v[site.layer] for f, v in full.items()})
        new = refresh_state(x, state, 0.0, ema_decay=self.cfg.ema_decay,
                            target_max=s2fp8.FMT_TARGET_MAX[fmt],
                            backend=backend)
        for f in STATE_FIELDS:
            if site.layer is None:
                full[f] = new[f]
            else:
                full[f][site.layer] = new[f]
        return torch.stack([new["alpha"], new["beta"]])

    def truncate(self, x, *, fmt="e5m2", backend=None):
        ab = self.site("t").refresh("fwd", x, fmt, backend)
        return nbackend.get_backend(backend).truncate(x, stats=ab, fmt=fmt)


# ---------------------------------------------------------------------------
# the active session (a thread-local, as in the reference)
# ---------------------------------------------------------------------------

_ACTIVE = threading.local()


def current_session() -> Optional[Session]:
    return getattr(_ACTIVE, "session", None)


@contextlib.contextmanager
def _activate(sess: Session):
    if current_session() is not None:
        raise RuntimeError("a StatsBank session is already active")
    _ACTIVE.session = sess
    try:
        yield sess
    finally:
        _ACTIVE.session = None


def freeze(bank):
    """Activate a :class:`FrozenSession` over ``bank`` (a bank dict or a
    :class:`FrozenBank`, which keeps the derived stats between calls)."""
    fb = bank if isinstance(bank, FrozenBank) else FrozenBank(bank)
    return _activate(FrozenSession(fb))


def calibrate(bank: Dict[str, Any], cfg: StatsConfig, device):
    """Activate a :class:`CalibratingSession` that refreshes ``bank`` in
    place (sites are added on first visit)."""
    return _activate(CalibratingSession(bank, cfg, device))


@contextlib.contextmanager
def scope(name: str):
    sess = current_session()
    if sess is None:
        yield
        return
    with sess.scope(name):
        yield


def segment_sites(name: str, length: int):
    sess = current_session()
    return None if sess is None else sess.segment_sites(name, length)


@contextlib.contextmanager
def segment_ctx(name: str, layer: int):
    sess = current_session()
    if sess is None:
        yield
        return
    with sess.segment_ctx(name, layer):
        yield
