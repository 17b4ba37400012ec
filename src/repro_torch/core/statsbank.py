"""StatsBank: per-site S2FP8 statistics, keyed like the reference's
(``repro.core.statsbank``), carried by the train step, frozen for serving
or calibrated forward-only.

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
    # + the six health leaves of obs/metrics.py TELE_FIELDS with
    #   StatsConfig(telemetry=True), refreshed with the stats

Site keys come from the same naming rules (``scope`` stack, per-prefix
counters, ``seg{i}:{btype}`` segment scope), so a bank exported by the
JAX package loads here unchanged (serving/bank.py ``load_serving_bank``).

The reference scans over layers and traces a segment's body once; the
port runs a Python loop over the layers, so :meth:`Session.segment_ctx`
takes the layer index and restores the naming counters on exit, which
gives every layer the same keys.

Four sessions exist here:

  * :class:`TrainSession` (``bind``) — training: each site reuses its
    carried (alpha, beta) and refreshes them only when due (every
    ``refresh_every`` steps, or while the site has never been refreshed),
    the reference's rule (``maybe_refresh``).  The decision is made on
    the host from the step and the cold-site map (``cold_sites``), so a
    steady step reads no device scalar and runs no stats reduction.  The
    reference returns refreshed states as the bank argument's cotangent;
    here the nodes' forward and backward write them into the session's
    ``updates`` (copy-on-write, so a steady step copies nothing) and the
    train step merges them into the bank it returns (``merge_updates``).
  * :class:`DiscoverySession` (``init_bank``) — one probe pass that
    records every site the model visits.
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

``force_refresh`` makes every cotangent-carrying site bootstrap again on
its next use, and :class:`HostStatsBank` is the eager keyed bank for
callers outside a train step (the refresh decision on the host, the
refresh numerics shared with the carried bank).

:class:`count_reductions` counts the aten reductions a step executes: a
steady banked step runs as many as an fp32 step, and so does an exact
step on the ``cuda_fused`` engine, whose stats run in kernels.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import backend as nbackend
from repro_torch.core import s2fp8
from repro_torch.obs import metrics as obs_metrics

STATE_FIELDS = ("alpha", "beta", "ema_mu", "ema_m", "last")
TRUNC_DIRS = ("fwd", "bwd")
GEMM_DIRS = ("a.fwd", "a.bwd", "b.fwd", "b.bwd", "out.fwd", "out.bwd")
FLASH_DIRS = ("q.fwd", "q.bwd", "k.fwd", "k.bwd", "v.fwd", "v.bwd",
              "out.fwd", "out.bwd")


@dataclasses.dataclass(frozen=True)
class StatsConfig:
    """``refresh_every``: refresh cadence; ``ema_decay``: EMA coefficient
    on the raw (mu, m) moments (0.0 replaces them at each refresh);
    ``axis_name``: when set (a mesh axis name or a tuple of them),
    refreshes all-reduce the (sum, max, count) partials over those axes
    of the mesh bound by the train step (``collectives.bind``): global
    stats across the ranks; :func:`for_mesh` derives it from a mesh's
    batch axes.  ``telemetry``: site states carry the per-site FP8 health
    leaves (``obs/metrics.py``), recomputed on each refresh (steady steps
    stay free of reductions) and drained by ``obs/telemetry.py``."""

    refresh_every: int = 16
    ema_decay: float = 0.0
    axis_name: Optional[Union[str, Tuple[str, ...]]] = None
    telemetry: bool = False

    def __post_init__(self):
        if self.refresh_every < 1:
            raise ValueError("refresh_every must be >= 1")
        if not (0.0 <= self.ema_decay < 1.0):
            raise ValueError("ema_decay must be in [0, 1)")
        if isinstance(self.axis_name, list):
            object.__setattr__(self, "axis_name", tuple(self.axis_name))


def for_mesh(cfg: StatsConfig, mesh) -> StatsConfig:
    """``cfg`` with ``axis_name`` bound to ``mesh``'s batch axes, so every
    refresh in the mesh-native train step all-reduces its partials across
    the data shards (stats of the global batch); ``mesh=None`` or a mesh
    without batch axes clears it."""
    if mesh is None:
        return dataclasses.replace(cfg, axis_name=None)
    from repro_torch.parallel import sharding as shd
    axes = shd.mesh_batch_axes(mesh)
    if not axes:
        return dataclasses.replace(cfg, axis_name=None)
    return dataclasses.replace(
        cfg, axis_name=axes[0] if len(axes) == 1 else axes)


def init_site_state(length: Optional[int] = None, device=None,
                    telemetry: bool = False) -> Dict[str, torch.Tensor]:
    """Identity stats, empty EMA, ``last = -1`` (bootstrap on first use);
    ``telemetry`` adds the zeroed health leaves (a cold site reports
    clean)."""
    shape = () if length is None else (length,)

    def full(v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    state = {"alpha": full(1.0), "beta": full(0.0), "ema_mu": full(0.0),
             "ema_m": full(0.0), "last": full(-1.0)}
    if telemetry:
        state.update(obs_metrics.init_tele_state(shape, device))
    return state


def refresh_state(x: torch.Tensor, state: Dict[str, torch.Tensor], step_f,
                  *, ema_decay: float = 0.0,
                  target_max: float = s2fp8.TARGET_MAX_LOG2,
                  backend: Optional[str] = None,
                  axis_name=None, split=None) -> Dict[str, torch.Tensor]:
    """One refresh: raw moments of ``x`` folded into the EMAs, (alpha, beta)
    re-derived — the reference's rule, op for op.  ``split``: ``x`` is the
    rank's slice of a tensor split over that mesh axis (the model axis),
    whose partials combine first (``backend.split_stats_partials``).
    With ``axis_name`` the (sum, max, count) partials are then all-reduced
    over those mesh axes (``backend.all_reduce_stats_partials``).  A state that carries the
    telemetry leaves gets its health metrics recomputed, measured against
    its pre-refresh stats (``obs_metrics.health_update``), in the payload
    format that ``target_max`` belongs to."""
    be = nbackend.get_backend(backend)
    log_sum, log_max, count = be.compute_stats_partials(x)
    if split is not None:
        log_sum, log_max, count = nbackend.split_stats_partials(
            (log_sum, log_max, count), split)
    if axis_name is not None:
        log_sum, log_max, count = nbackend.all_reduce_stats_partials(
            (log_sum, log_max, count), axis_name)
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
    new = {"alpha": alpha, "beta": beta, "ema_mu": ema_mu, "ema_m": ema_m,
           "last": new_last}
    if obs_metrics.has_telemetry(state):
        new.update(obs_metrics.health_update(
            x, state, new, mu_t, m_t, has, first, count,
            fmt=obs_metrics.resolve_fmt(target_max), backend=backend,
            axis_name=_with_split(axis_name, split)))
    return new


def _with_split(axis_name, split):
    """The mesh axes a sharded tensor's sums run over: ``split`` (the model
    axis) then ``axis_name``'s."""
    if split is None:
        return axis_name
    rest = () if axis_name is None else (
        (axis_name,) if isinstance(axis_name, str) else tuple(axis_name))
    return (split,) + rest


def maybe_refresh(x: torch.Tensor, state: Dict[str, torch.Tensor],
                  need: bool, step_f, cfg: StatsConfig, target_max: float,
                  backend: Optional[str] = None, split=None):
    """(ab, new_state or None): refresh from ``x`` when ``need`` (a host
    bool), else the carried (alpha, beta) — refresh-then-use on refresh
    steps, no reduction otherwise."""
    if need:
        new = refresh_state(x, state, step_f, ema_decay=cfg.ema_decay,
                            target_max=target_max, backend=backend,
                            axis_name=cfg.axis_name, split=split)
        return torch.stack([new["alpha"], new["beta"]]), new
    return torch.stack([state["alpha"], state["beta"]]), None


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
    ``refresh(direction, x, fmt)`` refreshes a state from ``x`` and returns
    the stats to use (calibrating and training sessions); ``need``,
    ``carried`` and ``stats`` are the training session's cadence."""

    def __init__(self, session: "Session", key: str):
        self.session = session
        self.key = key
        self.layer = session.layer

    def frozen(self, direction: str, fmt: str) -> torch.Tensor:
        ab = self.session.frozen_bank.stats(self.key, direction, fmt)
        return ab if self.layer is None else ab[self.layer]

    def refresh(self, direction: str, x: torch.Tensor, fmt: str,
                backend: Optional[str] = None, split=None) -> torch.Tensor:
        return self.session.refresh(self, direction, x, fmt, backend,
                                    split=split)

    def need(self, direction: str) -> bool:
        return self.session.need(self, direction)

    def carried(self, direction: str) -> torch.Tensor:
        st = self.session.state(self, direction)
        return torch.stack([st["alpha"], st["beta"]])

    def stats(self, direction: str, x: torch.Tensor, fmt: str,
              backend: Optional[str] = None, split=None) -> torch.Tensor:
        """The (alpha, beta) to use for ``x``: refreshed from it when due
        (refresh-then-use), else carried (training sessions).  ``split``:
        ``x`` is the rank's slice of a tensor split over that mesh axis;
        a refresh takes the whole tensor's stats."""
        return self.session.stats(self, direction, x, fmt, backend,
                                  split=split)


class Session:
    """Naming shared by every session: scopes, per-prefix counters and
    segment contexts produce the reference's site keys."""

    frozen = False
    discovery = False

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

    @contextlib.contextmanager
    def shared_ctx(self):
        """Mint the same unsegmented keys on every entry: the counters are
        restored on exit, so each pass of a layer loop run inside it
        visits the same sites (the reference's scan body traced once
        outside any segment)."""
        saved = dict(self._counters)
        try:
            yield
        finally:
            self._counters = saved

    def site(self, kind: str) -> Site:
        key = self._site_key(kind)
        self._require(key, kind)
        return Site(self, key)

    def state(self, site: Site, direction: str) -> Dict[str, torch.Tensor]:
        """The site's carried state (its layer's row inside a segment)."""
        full = self.bank[site.key][direction]
        return (full if site.layer is None
                else {f: v[site.layer] for f, v in full.items()})

    def _require(self, key: str, kind: str) -> None:
        if key not in self.bank:
            raise KeyError(
                f"site {key!r} has no StatsBank entry — the bank does not "
                f"match this model; calibrate or export it again")

    def truncate(self, x: torch.Tensor, *, fmt: str = "e5m2",
                 backend: Optional[str] = None, split=None) -> torch.Tensor:
        raise NotImplementedError

    def operand_stats(self, x: torch.Tensor, *, fmt: str = "e5m2"
                      ) -> torch.Tensor:
        """Read-only (alpha, beta) of a ``Policy.qdot`` operand (site kind
        ``q``, direction "fwd" only), re-derived from the site's carried
        moments for ``fmt`` (``frozen_stats``); a never-refreshed site
        gives identity stats.  No session refreshes such a site: eager
        callers keep their stats warm with :class:`HostStatsBank`, as in
        the reference."""
        alpha, beta = frozen_stats(self.state(self.site("q"), "fwd"), fmt)
        return torch.stack([alpha, beta])


class FrozenSession(Session):
    """Read-only serving session: frozen stats at every site, no reductions."""

    frozen = True

    def __init__(self, frozen_bank: FrozenBank):
        super().__init__(frozen_bank.bank, StatsConfig())
        self.frozen_bank = frozen_bank

    def truncate(self, x, *, fmt="e5m2", backend=None, split=None):
        ab = self.site("t").frozen("fwd", fmt)
        return nbackend.get_backend(backend).truncate(x, stats=ab, fmt=fmt)


_KIND_DIRS = {"t": TRUNC_DIRS, "qt": GEMM_DIRS, "qf": FLASH_DIRS,
              "q": ("fwd",)}


class CalibratingSession(Session):
    """Forward-only calibration: refresh-then-use at every visit (every
    site is due, so the banked nodes' forward serves it), sites minted on
    first visit (``[L]`` rows inside segments), each a copy of ``seed``'s
    entry where that has the same directions, fields and shapes (a train
    bank's), else fresh."""

    def __init__(self, bank: Dict[str, Any], cfg: StatsConfig, device,
                 seed: Optional[Dict[str, Any]] = None):
        if cfg.refresh_every != 1:
            raise ValueError("a calibrating session refreshes at every "
                             "visit: refresh_every must be 1")
        super().__init__(bank, cfg)
        self.device = device
        self.seed = seed or {}

    def _require(self, key, kind):
        if key in self.bank:
            return
        length = None if self._segment is None else self._segment_length
        entry = {d: init_site_state(length, self.device)
                 for d in _KIND_DIRS[kind]}
        seeded = self.seed.get(key)
        if seeded is not None and _same_layout(seeded, entry):
            entry = {d: {f: torch.as_tensor(v, dtype=torch.float32,
                                            device=self.device).clone()
                         for f, v in st.items()}
                     for d, st in seeded.items()}
        self.bank[key] = entry

    def refresh(self, site: Site, direction: str, x: torch.Tensor, fmt: str,
                backend: Optional[str] = None, split=None) -> torch.Tensor:
        full = self.bank[site.key][direction]
        new = refresh_state(x, self.state(site, direction), 0.0,
                            ema_decay=self.cfg.ema_decay,
                            target_max=s2fp8.FMT_TARGET_MAX[fmt],
                            backend=backend, split=split)
        for f in new:
            if site.layer is None:
                full[f] = new[f]
            else:
                full[f][site.layer] = new[f]
        return torch.stack([new["alpha"], new["beta"]])

    def need(self, site: Site, direction: str) -> bool:
        return True

    def stats(self, site: Site, direction: str, x: torch.Tensor, fmt: str,
              backend: Optional[str] = None, split=None) -> torch.Tensor:
        return self.refresh(site, direction, x, fmt, backend, split=split)

    def truncate(self, x, *, fmt="e5m2", backend=None, split=None):
        ab = self.site("t").refresh("fwd", x, fmt, backend, split=split)
        return nbackend.get_backend(backend).truncate(x, stats=ab, fmt=fmt)


def _same_layout(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    """Two site entries with the same directions, fields and shapes."""
    return set(a) == set(b) and all(
        set(a[d]) == set(b[d]) and all(
            tuple(a[d][f].shape) == tuple(b[d][f].shape) for f in b[d])
        for d in b)


class _TruncateBanked(torch.autograd.Function):
    """Bank-routed bidirectional truncation (paper Fig. 4): Eq. 5 on the
    forward value with the site's "fwd" stats, on the cotangent with its
    "bwd" stats, each refreshed when due."""

    @staticmethod
    def forward(ctx, x, site, fmt, backend, split=None):
        ctx.meta = (site, fmt, backend, split)
        ab = site.stats("fwd", x, fmt, backend, split=split)
        return nbackend.get_backend(backend).truncate(x, stats=ab, fmt=fmt)

    @staticmethod
    def backward(ctx, g):
        site, fmt, backend, split = ctx.meta
        ab = site.stats("bwd", g, fmt, backend, split=split)
        return (nbackend.get_backend(backend).truncate(g, stats=ab, fmt=fmt),
                None, None, None, None)


class TrainSession(Session):
    """A train step's view of the bank.  ``cold`` maps site -> direction ->
    host bool (an array over the layers inside a segment): the sites whose
    ``last`` is still < 0.  A site-direction refreshes when the step is a
    refresh step (``step % refresh_every == 0``) or it is cold."""

    def __init__(self, bank: Dict[str, Any], step: int, cfg: StatsConfig,
                 cold: Dict[str, Dict[str, np.ndarray]]):
        super().__init__(bank, cfg)
        self.step = int(step)
        self.pred = self.step % cfg.refresh_every == 0
        self.cold = cold
        self.updates: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {}

    def _require(self, key, kind):
        if key not in self.bank:
            raise KeyError(
                f"site {key!r} has no StatsBank entry — the model structure "
                f"changed since the bank was initialized; re-run "
                f"statsbank.init_bank")

    def need(self, site: Site, direction: str) -> bool:
        if self.pred:
            return True
        c = self.cold[site.key][direction]
        return bool(c if site.layer is None else c[site.layer])

    def stats(self, site: Site, direction: str, x: torch.Tensor, fmt: str,
              backend: Optional[str] = None,
              need: Optional[bool] = None, split=None) -> torch.Tensor:
        if need is None:
            need = self.need(site, direction)
        ab, new = maybe_refresh(x, self.state(site, direction), need,
                                self.step, self.cfg,
                                s2fp8.FMT_TARGET_MAX[fmt], backend,
                                split=split)
        if new is not None:
            entry = self.updates.setdefault(site.key, {})
            if direction not in entry:       # copy on first write
                entry[direction] = {f: v.clone() for f, v in
                                    self.bank[site.key][direction].items()}
            upd = entry[direction]
            for f in new:
                if site.layer is None:
                    upd[f] = new[f]
                else:
                    upd[f][site.layer] = new[f]
        return ab

    def refresh(self, site: Site, direction: str, x: torch.Tensor, fmt: str,
                backend: Optional[str] = None, split=None) -> torch.Tensor:
        return self.stats(site, direction, x, fmt, backend, need=True,
                          split=split)

    def truncate(self, x, *, fmt="e5m2", backend=None, split=None):
        return _TruncateBanked.apply(x, self.site("t"), fmt, backend, split)


class DiscoverySession(Session):
    """Records every site a probe pass visits (key, segment, directions);
    the nodes run their exact-stats path meanwhile."""

    discovery = True

    def __init__(self, cfg: StatsConfig):
        super().__init__({}, cfg)
        self.recorded: Dict[str, Tuple[Optional[str], Tuple[str, ...]]] = {}
        self.segment_lengths: Dict[str, int] = {}

    def segment_sites(self, name: str, length: int):
        self.segment_lengths[name] = length
        return None

    def site(self, kind: str) -> None:
        key = self._site_key(kind)
        self.recorded[key] = (None if self._segment is None
                              else self._segment[0], _KIND_DIRS[kind])
        return None

    def truncate(self, x, *, fmt="e5m2", backend=None, split=None):
        self.site("t")
        return x

    def operand_stats(self, x, *, fmt="e5m2"):
        self.site("q")
        return torch.tensor([1.0, 0.0], dtype=torch.float32, device=x.device)


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


@contextlib.contextmanager
def resume(sess: Optional[Session]):
    """Run under ``sess`` in this thread too (a no-op where it is already
    the active one).  The autograd engine replays a rematerialized layer on
    its own device thread, where the thread-local session of the forward
    is not active."""
    if sess is None or current_session() is sess:
        yield
        return
    with _activate(sess):
        yield


def freeze(bank):
    """Activate a :class:`FrozenSession` over ``bank`` (a bank dict or a
    :class:`FrozenBank`, which keeps the derived stats between calls)."""
    fb = bank if isinstance(bank, FrozenBank) else FrozenBank(bank)
    return _activate(FrozenSession(fb))


def calibrate(bank: Dict[str, Any], cfg: StatsConfig, device,
              seed: Optional[Dict[str, Any]] = None):
    """Activate a :class:`CalibratingSession` that refreshes ``bank`` in
    place (sites are added on first visit, from ``seed``'s entry where it
    has one of the same layout)."""
    return _activate(CalibratingSession(bank, cfg, device, seed))


def bind(bank: Dict[str, Any], step: int, cfg: StatsConfig = StatsConfig(),
         cold: Optional[Dict[str, Any]] = None):
    """Activate a :class:`TrainSession` over ``bank`` for one train step;
    refreshed states collect in the session's ``updates``.  ``cold``
    defaults to :func:`cold_sites` of ``bank`` (one host read)."""
    return _activate(TrainSession(bank, step, cfg,
                                  cold_sites(bank) if cold is None else cold))


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


@contextlib.contextmanager
def shared_sites():
    """Run a layer of a loop whose layers share one unsegmented entry per
    site (``Session.shared_ctx``); no-op without a session."""
    sess = current_session()
    if sess is None:
        yield
        return
    with sess.shared_ctx():
        yield


# ---------------------------------------------------------------------------
# discovery and bank bookkeeping
# ---------------------------------------------------------------------------

def init_bank(loss_fn: Callable, params, batch, policy,
              cfg: StatsConfig = StatsConfig()) -> Dict[str, Any]:
    """Discover the model's sites with one probe pass of ``loss_fn(params,
    batch, policy)`` (no autograd) and return a bank of fresh states
    (``last = -1``: every site bootstraps on its first step), [L]-stacked
    for sites inside a segment, on the params' device."""
    if current_session() is not None:
        raise RuntimeError("cannot run discovery inside an active session")
    sess = DiscoverySession(cfg)
    with _activate(sess), torch.no_grad():
        loss_fn(params, batch, policy)
    device = first_leaf(params).device
    bank = {key: {d: init_site_state(
                None if seg is None else sess.segment_lengths[seg], device,
                cfg.telemetry)
                  for d in dirs}
            for key, (seg, dirs) in sess.recorded.items()}
    if not bank:
        raise ValueError(
            "no truncation sites found — StatsBank requires an s2fp8-mode "
            f"policy (got mode={getattr(policy, 'mode', policy)!r})")
    return bank


def first_leaf(tree) -> torch.Tensor:
    """The first leaf of nested dicts/lists/tuples (a dict's first value)."""
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def merge_updates(bank: Dict[str, Any], updates: Dict[str, Any]
                  ) -> Dict[str, Any]:
    """The next step's bank: every state a session refreshed, the carried
    state elsewhere (states are never modified in place)."""
    return {k: {d: updates.get(k, {}).get(d, st) for d, st in entry.items()}
            for k, entry in bank.items()}


def force_refresh(bank: Dict[str, Any]) -> Dict[str, Any]:
    """``bank`` with ``last = -1`` on every cotangent-carrying site, so each
    bootstrap-refreshes (its EMA re-seeded) on its next use: the reset
    after numeric distress.  Read-only operand sites (``q``, "fwd" only)
    keep their entries: nothing refreshes them in a train step, so a -1
    there would stay cold for good."""
    return {k: ({d: dict(st, last=torch.full_like(st["last"], -1.0))
                 for d, st in e.items()}
                if any("bwd" in d for d in e) else e)
            for k, e in bank.items()}


def bookkeeping_last(bank: Dict[str, Any]) -> torch.Tensor:
    """Every site-direction's last-refresh step, concatenated."""
    return torch.cat([st["last"].reshape(-1)
                      for e in bank.values() for st in e.values()])


# ---------------------------------------------------------------------------
# counting executed reductions (reference statsbank.py count_reductions)
# ---------------------------------------------------------------------------

REDUCE_OPS = frozenset({
    "sum", "nansum", "mean", "nanmean", "prod", "max", "min", "amax", "amin",
    "aminmax", "argmax", "argmin", "logsumexp", "norm", "linalg_vector_norm",
    "_foreach_norm", "var", "std", "var_mean", "std_mean"})


class count_reductions(TorchDispatchMode):
    """Counts the aten reductions executed while the context is open (the
    port's counterpart of the reference's jaxpr ``count_reductions``:
    PyTorch runs eagerly, so what ran is what is counted).

    ``n`` counts reductions of a whole tensor to a scalar (a 0-dim result:
    the kind every S2FP8 stats reduction is, Eq. 3-4, and the loss and
    gradient-norm sums); ``by_op`` counts every reduction by aten overload
    and kind ("scalar" or "dim"), reductions along a dimension (norms,
    softmax, attention) included.  Elementwise overloads of ``max`` and
    ``min`` (``.other``) are not reductions and are not counted.  Work
    that runs inside a kernel of this repository does not reach aten and
    is not counted: on the ``cuda_fused`` engine a step's stats leave the
    count."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.by_op: Dict[Tuple[str, str], int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        pk = func.overloadpacket.__name__
        if pk in REDUCE_OPS and func._schema.overload_name != "other":
            outs = out if isinstance(out, (tuple, list)) else (out,)
            scalar = all(isinstance(o, torch.Tensor) and o.dim() == 0
                         for o in outs)
            key = (str(func), "scalar" if scalar else "dim")
            self.by_op[key] = self.by_op.get(key, 0) + 1
            self.n += int(scalar)
        return out


def cold_sites(bank: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """Site -> direction -> (per-layer) ``last < 0`` on the host, from one
    device read of :func:`bookkeeping_last`.  A fake bank (a dry trace's,
    made by :func:`init_bank` under ``FakeTensorMode``) has no values to
    read: it has never stepped, so every site is cold, as its ``last =
    -1`` would say."""
    from torch._subclasses.fake_tensor import is_fake
    mask = bookkeeping_last(bank) < 0
    cold = (np.ones(tuple(mask.shape), bool) if is_fake(mask)
            else mask.cpu().numpy().copy())
    out: Dict[str, Dict[str, np.ndarray]] = {}
    i = 0
    for k, e in bank.items():
        out[k] = {}
        for d, st in e.items():
            n = st["last"].numel()
            out[k][d] = cold[i:i + n].reshape(st["last"].shape)
            i += n
    return out


# ---------------------------------------------------------------------------
# host-side bank (reference statsbank.py:690-737; absorbs DelayedStatsCache)
# ---------------------------------------------------------------------------

class HostStatsBank:
    """Eager keyed bank for callers outside a train step (serving loops,
    checkpoint compression): the same per-site state and refresh numerics
    as the carried bank (``refresh_state``), with the refresh decision on
    the host.  ``truncate(x, key, step)`` refreshes when the key is new or
    ``step - last >= refresh_every``, else it is one elementwise pass with
    the stored (alpha, beta)."""

    def __init__(self, backend: Optional[str] = None,
                 refresh_every: int = 16, ema_decay: float = 0.0,
                 fmt: str = "e5m2"):
        if refresh_every < 1:
            raise ValueError("refresh_every must be >= 1")
        self.backend = backend
        self.refresh_every = refresh_every
        self.ema_decay = ema_decay
        self.fmt = fmt
        self.bank: Dict[str, Dict[str, torch.Tensor]] = {}

    def stats(self, key: str) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        st = self.bank.get(key)
        return None if st is None else (st["alpha"], st["beta"])

    def _site(self, x: torch.Tensor, key: str, step: int):
        """The site's state, refreshed when the key is new or stale (one
        host read of ``last``)."""
        st = self.bank.get(key)
        if st is None or step - float(st["last"]) >= self.refresh_every:
            st = refresh_state(
                x, st if st is not None else init_site_state(
                    device=x.device), float(step),
                ema_decay=self.ema_decay,
                target_max=s2fp8.FMT_TARGET_MAX[self.fmt],
                backend=self.backend)
            self.bank[key] = st
        return st

    def _ab(self, x: torch.Tensor, key: str, step: int) -> torch.Tensor:
        st = self._site(x, key, step)
        return torch.stack([st["alpha"], st["beta"]])

    def truncate(self, x: torch.Tensor, key: str, step: int) -> torch.Tensor:
        return nbackend.get_backend(self.backend).truncate(
            x, stats=self._ab(x, key, step), fmt=self.fmt)

    def quantize(self, x: torch.Tensor, key: str, step: int):
        """Bank-stats quantization to S2FP8 storage (compression callers)."""
        return nbackend.get_backend(self.backend).quantize(
            x, stats=self._ab(x, key, step), fmt=self.fmt)

    def clear(self) -> None:
        self.bank.clear()
