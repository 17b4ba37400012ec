"""Train-step factory and host training loop (port of
``repro.training.trainer``): numerics policy, FP32 master weights, the
StatsBank carry, the StepGuard, telemetry and chaos injection, the
mesh-native data-parallel and FSDP step over ``torch.distributed``, and
:class:`TrainLoop` with checkpoints, the watchdog and the escalation
ladder.

Loss scaling (paper Eq. 6): under ``fp8_ls`` the loss is multiplied by
``policy.loss_scale`` before the gradients are taken, so every truncated
cotangent is one of the scaled loss; the gradients and the reported loss
are divided by it after, with or without a bank.

``make_train_step`` returns, as the reference's does (``trainer.py:416``)::

    step(params, opt_state[, bank][, guard_state], batch, step)
        -> (params, opt_state[, bank][, guard_state], metrics)

with the bank when ``stats=...`` and the guard carry when ``guard=...``.
PyTorch runs eagerly, so the step is a plain function: the loss runs
under a :func:`statsbank.bind` session, autograd gives the gradients, the
session's refreshed states are merged into the returned bank, and the
optimizer updates ``params`` and ``opt_state`` in place (see
``optim/optimizers.py``).

The bank's refresh decision is made on the host: a site refreshes when
``step % refresh_every == 0`` or while it has never been refreshed
(``last < 0``).  The step keeps the cold-site map of the last bank it
returned and re-reads it (one device read, ``statsbank.cold_sites``) only
after a step that refreshed something or when it is handed another bank
(a forced refresh, a chaos mutation, a rollback, a restore), so a steady
step reads no device scalar.

The guard (``training/guard.py``) evaluates its verdict on the step's
loss and gradient norm before the optimizer runs and the host reads
``ok`` / ``ok_bank`` (one read): a rejected step skips the update and
keeps the input bank (a saturation trip keeps the refreshed one), so it
leaves params, optimizer state, bank and guard carry bit for bit as they
were.

With ``mesh=...`` (a ``launch/mesh.py`` :class:`Mesh`; one process per
rank) the same step runs on every rank: each rank is handed the global
batch and takes its own dim-0 slice by its coordinates on the batch axes
(all or nothing, ``sharding.mesh_batch_specs``); the loss is scaled by
``1 / n_shards`` inside the differentiated function, so the gradient sync
(``collectives.grad_sync_axis``: an f32 all-reduce per leaf, or the
S2FP8-compressed legs) is a pure sum; float metrics become global means,
integer ones global sums (divided back on the replicated-batch fallback),
bools an any; StatsBank refreshes all-reduce their partials
(``statsbank.for_mesh``), so the bank stays replicated; the guard's
verdict is taken on the post-sync globals, so every rank takes the same
branch and issues the same collectives in the same order; telemetry
drains on rank 0.  Under ``param_sharding="fsdp"`` / ``"fsdp_q"`` params
and optimizer state enter and leave the step as this rank's dim-0 shards
(``sharding.shard_tree``), gathered inside the differentiated loss.
``mesh=None`` is the meshless step above and issues no collective.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch

from repro_torch.core import collectives, s2fp8, statsbank
from repro_torch.core.policy import S2FP8_MODES, Policy
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.obs.sinks import ConsoleSink, NullSink
from repro_torch.optim import optimizers as optim_mod
from repro_torch.optim.optimizers import (Optimizer, global_norm,
                                          tree_leaves, tree_unflatten)
from repro_torch.parallel import sharding as shd
from repro_torch.training import chaos as chaos_mod
from repro_torch.training import fault
from repro_torch.training import guard as guard_mod

GRAD_SYNC_MODES = ("f32", "s2fp8")
PARAM_SHARDING_MODES = ("replicated", "fsdp", "fsdp_q")


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    schedule: Callable, policy: Policy,
                    track_stats: bool = False,
                    stats: Optional[statsbank.StatsConfig] = None,
                    telemetry: Optional[obs_telemetry.Telemetry] = None,
                    guard: Optional[guard_mod.GuardConfig] = None, *,
                    grad_sync: Optional[Callable] = None,
                    mesh=None, grad_sync_mode: str = "f32",
                    grad_sync_min_size: int = 1 << 16,
                    grad_sync_backend: Optional[str] = None,
                    param_sharding: str = "replicated",
                    placement: Optional[shd.Placement] = None):
    """``loss_fn(params, batch, policy) -> (loss, metrics)``; ``stats``
    enables the StatsBank carry (build the first bank with
    ``statsbank.init_bank(loss_fn, params, batch, policy, stats)``);
    ``telemetry`` (needs ``stats``, with ``telemetry=True`` for non-empty
    records) drains the bank's health leaves to its sink on the steps it
    is due; ``guard`` arms the StepGuard (carry: ``guard.init_state``).
    A ``batch["_chaos"]`` entry (``chaos.wrap_data_fn``) is popped off the
    batch and drives the in-step injectors.
    Metrics: loss, grad_norm (before clipping), lr, the loss_fn's own, with
    a bank ``stats_refreshed`` (1.0 when any site refreshed), with the
    guard ``guard_ok``, ``guard_nonfinite``, ``guard_spike``,
    ``guard_sat``, ``guard_forced``, and with ``track_stats``
    ``probe_stats``: ``s2fp8.tensor_stats`` (mu, m, alpha, beta) of the
    last gradient leaf in the reference's leaf order (paper Fig. 5).

    ``grad_sync``: an optional synchronizer of the meshless step's
    gradient tuple (legacy hook; must be None under a mesh).  ``mesh``
    makes the step mesh-native (module docstring); ``grad_sync_mode``
    "f32" all-reduces every gradient leaf in f32, "s2fp8" takes the
    compressed legs for every leaf ``collectives.leaf_sync_route`` deems
    compressible (floor ``grad_sync_min_size`` elements; encode and
    decode on the engine ``grad_sync_backend``).  ``param_sharding``:
    "replicated" (every rank holds full copies), "fsdp" (eligible leaves
    live as dim-0 shards over the rule table's fsdp axis: f32 all-gather
    inside the loss, gradients reduce-scattered back by the gather's
    backward, the update on the shards under ``optimizers.fsdp_grads``)
    or "fsdp_q" (payload-eligible 2-D leaves additionally reach the
    payload GEMMs as ``collectives.FSDPPayloadParam``: quantized at the
    owner with the leaf-global bank stats, 1-byte all-gather; needs
    ``stats`` and a payload-GEMM policy).  Build the bank from the full
    params (``statsbank.init_bank``) before ``sharding.shard_tree``.
    ``placement`` (a ``sharding.Placement``, on a mesh, with
    ``param_sharding`` "replicated"): params and optimizer state are the
    rank's leaves as ``sharding.place_params`` placed them by
    ``param_pspecs``; each use gathers the dims stored split over an axis
    the model computes whole (a ``data`` gather's backward
    reduce-scatters the gradient, which then skips the batch sync), and
    the norms sum each leaf's squares over the axes it is stored split
    over.

    Called under active sharding rules (``sharding.use_rules``: the dry
    run, the tests), the mesh step keeps them, so the model computes its
    part of the model axis; called without (the train launcher), it
    suspends them and replicates the model axis, as the reference's
    mesh-native step does."""
    if stats is not None and policy.mode not in S2FP8_MODES:
        raise ValueError(
            f"StatsBank requires an s2fp8-mode policy, got {policy.mode!r}")
    if telemetry is not None and stats is None:
        raise ValueError("telemetry requires a StatsBank (stats=...)")
    if grad_sync_mode not in GRAD_SYNC_MODES:
        raise ValueError(f"grad_sync_mode must be one of {GRAD_SYNC_MODES}, "
                         f"got {grad_sync_mode!r}")
    if mesh is not None and grad_sync is not None:
        raise ValueError("mesh=... builds its own gradient sync; the "
                         "legacy grad_sync callable must be None")
    if param_sharding not in PARAM_SHARDING_MODES:
        raise ValueError(f"param_sharding must be one of "
                         f"{PARAM_SHARDING_MODES}, got {param_sharding!r}")
    if placement is not None and (mesh is None
                                  or param_sharding != "replicated"):
        raise ValueError("placement=... places the params on a mesh by "
                         "param_pspecs: it needs mesh=... and no other "
                         "param_sharding")
    scale = policy.loss_scale if policy.mode == "fp8_ls" else 1.0

    batch_axes = shd.mesh_batch_axes(mesh) if mesh is not None else ()
    axis_name = (None if not batch_axes
                 else batch_axes[0] if len(batch_axes) == 1 else batch_axes)
    n_shards = shd.mesh_batch_size(mesh) if mesh is not None else 1
    axis_sizes = ({a: mesh.shape[a] for a in batch_axes}
                  if mesh is not None else {})
    if stats is not None and mesh is not None:
        stats = statsbank.for_mesh(stats, mesh)
    fsdp_axis = shd.fsdp_axis_entry(mesh) if mesh is not None else None
    gather_f32 = pay_info = None
    if param_sharding != "replicated":
        if mesh is None or fsdp_axis is None:
            raise ValueError(f"param_sharding={param_sharding!r} needs a "
                             f"mesh whose axes carry the rule table's "
                             f"'fsdp' logical axis")
        if param_sharding == "fsdp_q":
            if stats is None:
                raise ValueError("param_sharding='fsdp_q' quantizes at "
                                 "the owner with leaf-global bank stats — "
                                 "pass stats=StatsConfig(...)")
            if not policy.uses_payload_gemm:
                raise ValueError("param_sharding='fsdp_q' streams payload "
                                 "operands; the policy must route GEMMs "
                                 "through qdot_train (s2fp8 mode with "
                                 "gemm_mode='payload' or a kernel engine)")
        lead_axes = tuple(a for a in batch_axes if a != fsdp_axis)
        base_info = collectives.FSDPInfo(
            fsdp_axis, mesh.shape[fsdp_axis], lead_axes, grad_sync_mode,
            grad_sync_min_size, grad_sync_backend, mesh=mesh)
        gather_f32 = collectives.make_param_gather(base_info)
        pay_info = base_info._replace(gather_f32=gather_f32)

    def scaled(loss):
        # loss scaling (Eq. 6) and the data-parallel mean both fold into
        # the differentiated function: per-shard gradients are
        # contributions to the global mean and the sync is a pure sum
        if scale != 1.0:
            loss = loss * scale
        if n_shards > 1:
            loss = loss / float(n_shards)
        return loss

    def _global(x: torch.Tensor) -> torch.Tensor:
        return collectives.all_reduce(x.reshape(1).clone(), axis_name)[0]

    def _reduce_metrics(metrics, int_div: int):
        # every metric leaves the step replicated: floats the global mean
        # of the per-shard means, integers the global sum (divided back on
        # the replicated-batch fallback), bools an any
        out = {}
        for k, v in metrics.items():
            if not isinstance(v, torch.Tensor) or v.dim() != 0:
                out[k] = v
            elif v.is_floating_point():
                out[k] = _global(v / float(n_shards) if n_shards > 1 else v)
            elif v.dtype == torch.bool:
                out[k] = _global(v.to(torch.int32)) > 0
            else:
                s_ = _global(v)
                out[k] = s_ // int_div if int_div > 1 else s_
        return out

    def _gather_params(params, elig, pay):
        # FSDP just-in-time gather, inside the differentiated loss: an
        # eligible shard leaves through the f32 gather (its backward
        # reduce-scatters the gradient back) or, payload-eligible under
        # fsdp_q, wrapped for the payload GEMM
        out = []
        for leaf, e, q in zip(tree_leaves(params), elig, pay):
            if not e:
                out.append(leaf)
            elif q:
                out.append(collectives.FSDPPayloadParam(leaf, pay_info))
            else:
                out.append(gather_f32(leaf))
        return tree_unflatten(params, out)

    # the cold-site map of the bank this step returned last
    carried = {"bank": None, "cold": None}

    def _step(params, opt_state, bank, guard_state, batch, step):
        batch, chaos_fields = chaos_mod.split_batch(batch)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        elig = None
        loss_params = params
        norm_axes = None
        if mesh is not None:
            int_div = 1 if shd.batch_is_sharded(batch, mesh) else n_shards
            batch = shd.shard_batch(batch, mesh)
            if placement is not None:
                elig = placement.batch_reduced()
                norm_axes = placement.stored_axes()
                loss_params = placement.for_compute(params)
            elif param_sharding != "replicated":
                elig = [shd.is_shard(p) for p in leaves]
                pay = [bool(e and param_sharding == "fsdp_q"
                            and p.dim() == 2) for p, e in zip(leaves, elig)]
                loss_params = _gather_params(params, elig, pay)
        sess = None
        if bank is None:
            loss, metrics = loss_fn(loss_params, batch, policy)
            loss = scaled(loss)
            grads = torch.autograd.grad(loss, leaves)
        else:
            cold = (carried["cold"] if bank is carried["bank"]
                    else statsbank.cold_sites(bank))
            with statsbank.bind(bank, step, stats, cold) as sess:
                loss, metrics = loss_fn(loss_params, batch, policy)
                loss = scaled(loss)
                # inside the session: remat replays layers in the backward
                grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        if scale != 1.0:
            grads = tuple(g / scale for g in grads)
            loss = loss / scale
        out = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            # FSDP gradients left autograd already reduce-scattered to
            # their owner: the replicated sync skips them
            grads = tuple(collectives.grad_sync_axis(
                list(grads), axis_name, axis_sizes, mode=grad_sync_mode,
                min_size=grad_sync_min_size, backend=grad_sync_backend,
                skip=elig))
            out = _reduce_metrics(out, int_div)
            loss = _global(loss)
        elif grad_sync is not None:
            grads = tuple(grad_sync(grads))
        # in-step fault injection, where the reference places it: on the
        # scaled-back (post-sync) loss and gradients, before the guard
        loss = chaos_mod.inject_loss(chaos_fields, loss, step)
        grads = tree_unflatten(
            params, chaos_mod.inject_grads(chaos_fields, grads, step))
        # under FSDP the norms (the metric and the optimizer's clip) sum
        # the shards' squares over the fsdp axis
        def norm_scope():
            if norm_axes is not None:
                return optim_mod.fsdp_grads(None, norm_axes)
            return (optim_mod.fsdp_grads(fsdp_axis, elig)
                    if elig is not None else contextlib.nullcontext())
        out["loss"] = loss
        with norm_scope():
            out["grad_norm"] = global_norm(grads)
        out["lr"] = schedule(step)
        if track_stats:
            out["probe_stats"] = s2fp8.tensor_stats(tree_leaves(grads)[-1])
        new_bank = None
        if sess is not None:
            new_bank = statsbank.merge_updates(bank, sess.updates)
            out["stats_refreshed"] = float(bool(sess.updates))
        ok = ok_bank = True
        new_guard = None
        if guard is not None:
            sat_margin = None
            if new_bank is not None and guard.sat_threshold > 0:
                _, sat_margin = guard_mod.bank_probe(bank, new_bank,
                                                     guard.sat_threshold)
            flags, new_guard = guard_mod.evaluate(
                guard, guard_state, loss, out["grad_norm"], sat_margin,
                chaos_mod.forced_reject(chaos_fields, step))
            ok, ok_bank = torch.stack([flags["ok"],
                                       flags["ok_bank"]]).tolist()
            out.update(guard_mod.flag_metrics(flags))
        if ok:
            with norm_scope():
                params, opt_state = optimizer.update(grads, opt_state,
                                                     params, out["lr"])
        if new_bank is not None:
            if not ok_bank:
                new_bank = bank
            carried["bank"] = new_bank
            carried["cold"] = (statsbank.cold_sites(new_bank)
                               if ok_bank and sess.updates else cold)
            if telemetry is not None and telemetry.due(step) \
                    and (mesh is None or mesh.rank == 0):
                telemetry.drain(
                    obs_telemetry.telemetry_state(new_bank, step), step)
        return params, opt_state, new_bank, new_guard, out

    if mesh is not None:
        _local = _step

        def _step(*args):
            # the caller's sharding rules stay on (the model splits the
            # model axis), else they are off inside the step; axis names
            # resolve against this mesh in every thread (the autograd
            # engine's too)
            rules = (contextlib.nullcontext() if shd.active()
                     else shd.suspend_rules())
            with rules, collectives.bind(mesh):
                return _local(*args)

    if stats is None and guard is None:
        def train_step(params, opt_state, batch, step):
            p, o, _, _, out = _step(params, opt_state, None, None, batch,
                                    step)
            return p, o, out
        return train_step
    if stats is None:
        def train_step_guarded(params, opt_state, guard_state, batch, step):
            p, o, _, g, out = _step(params, opt_state, None, guard_state,
                                    batch, step)
            return p, o, g, out
        return train_step_guarded
    if guard is None:
        def banked_train_step(params, opt_state, bank, batch, step):
            p, o, b, _, out = _step(params, opt_state, bank, None, batch,
                                    step)
            return p, o, b, out
        return banked_train_step

    def banked_train_step_guarded(params, opt_state, bank, guard_state,
                                  batch, step):
        return _step(params, opt_state, bank, guard_state, batch, step)
    return banked_train_step_guarded


def make_eval_step(loss_fn: Callable, policy: Policy):
    """``eval_step(params, batch) -> metrics`` (no autograd)."""
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch, policy)
        return metrics
    return eval_step


def _host_metrics(metrics: dict) -> dict:
    """``metrics`` with every 0-d tensor (nested dicts too) a Python float,
    read in one transfer per dict."""
    out = dict(metrics)
    keys = [k for k, v in out.items()
            if isinstance(v, torch.Tensor) and v.dim() == 0]
    if keys:
        vals = torch.stack([out[k].detach().float() for k in keys]).tolist()
        out.update(zip(keys, vals))
    for k, v in out.items():
        if isinstance(v, dict):
            out[k] = _host_metrics(v)
    return out


class TrainLoop:
    """Host-side loop: checkpoint-every-k, auto-resume, watchdog, and the
    resilience escalation ladder (port of the reference's ``TrainLoop``).

    ``stats_bank``: the StatsBank carry for a step built with
    ``make_train_step(..., stats=...)``; it is checkpointed alongside
    (params, opt_state) and restored by ``maybe_resume``.

    ``guard_state``: the StepGuard carry for a step built with
    ``make_train_step(..., guard=...)``.  When the step's ``guard_ok``
    metric reports a trip (the update was already rejected in the step),
    the loop walks the escalation ladder, one rung per CONSECUTIVE trip:

        1. skip        — the rejection is the whole intervention
        2. force a StatsBank refresh (``statsbank.force_refresh``: every
           site bootstrap-refreshes next step, EMA re-seeded)
        3. roll back   — restore the newest :class:`guard.SnapshotRing`
           entry and rewind the step counter (deterministic data makes the
           replay exact; chaos injections are single-fire, so a replayed
           fault step runs clean)
        4. restore the newest VALID checkpoint (the manager quarantines
           corrupt ones on the way)

    Inapplicable rungs collapse (no bank -> 2 skipped; empty ring -> 3
    falls through to 4; no checkpoint -> keep skipping).  A clean step
    resets the rung.  Every intervention is emitted through ``sink`` as a
    structured event: ``guard_tripped``, ``stats_refresh_forced``,
    ``rollback``, ``checkpoint_restore`` (plus the manager's
    ``checkpoint_quarantined``).  ``max_interventions`` bounds a
    persistently-faulting run (RuntimeError instead of a silent loop).

    ``snapshot_every=k`` pushes (params, opt[, bank][, guard]) onto an
    in-memory :class:`guard.SnapshotRing` after every k-th clean step
    (``snapshot_compress=True`` routes big leaves through the S2FP8
    codec on the numerics engine ``codec_backend``; lossy).

    ``chaos``: a ``training/chaos.ChaosPlan`` — the loop calls its
    host-side hooks (bank mutation before the step, straggler sleep
    inside the timed span, checkpoint corruption after a save); the
    in-step schedule must additionally ride the batch via
    ``chaos.wrap_data_fn``.

    ``watchdog_escalate_after=N``: N consecutive watchdog trips push a
    proactive snapshot and emit ``watchdog_escalated`` (0 disables).

    ``sink``: a ``repro_torch.obs.MetricsSink`` receiving per-step
    ``"train_step"`` records with span timings (data / device-synchronized
    step / checkpoint / refresh wall-clock) every ``log_every`` steps, plus
    the step's ``aux`` and ``probe_stats`` metrics where it has them, and
    ``"event"`` records.
    Defaults to a ``ConsoleSink`` over ``run``'s ``print_fn``.

    ``mesh``: the loop of one rank of a mesh-native step (every rank runs
    the same loop).  Records, console lines and telemetry go out on rank
    0 only; every host decision — the refresh cadence, the guard ladder,
    rollbacks — comes from replicated metrics, and the watchdog reads the
    slowest rank's step time (one max all-reduce a step), so all ranks
    issue the same collectives in the same order.  The checkpoint manager
    must be built with the same mesh; rollbacks and restores keep the
    params' and moments' FSDP shard marks.
    """

    def __init__(self, train_step, params, opt_state, data_fn,
                 ckpt_manager=None, ckpt_every: int = 0,
                 log_every: int = 10, watchdog_factor: float = 3.0,
                 stats_bank=None, sink=None, guard_state=None,
                 chaos=None, snapshot_every: int = 0,
                 snapshot_ring: int = 4, snapshot_compress: bool = False,
                 watchdog_escalate_after: int = 0,
                 max_interventions: int = 32,
                 codec_backend: Optional[str] = None, mesh=None):
        self.train_step = train_step
        self.mesh = mesh
        self.params = params
        self.opt_state = opt_state
        self.stats_bank = stats_bank
        self.guard_state = guard_state
        self.data_fn = data_fn
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.watchdog_factor = watchdog_factor
        self.watchdog_escalate_after = watchdog_escalate_after
        self.chaos = chaos
        self.snapshot_every = snapshot_every
        self.ring = (guard_mod.SnapshotRing(snapshot_ring,
                                            compress=snapshot_compress,
                                            backend=codec_backend)
                     if snapshot_every else None)
        self.max_interventions = max_interventions
        self.sink = sink
        self.start_step = 0
        self.history = []
        # which leaves of the state tree are FSDP shards (restored trees
        # are new tensors: _load_state marks them again)
        self._shard_flags = (shd.shard_flags(self._state_tree())
                             if mesh is not None else None)

    @property
    def lead(self) -> bool:
        """Whether this rank writes records (rank 0, or no mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    # -- state tree plumbing ------------------------------------------------
    def _state_tree(self):
        """(params, opt[, bank][, guard]) — the checkpoint/snapshot unit."""
        tree = [self.params, self.opt_state]
        if self.stats_bank is not None:
            tree.append(self.stats_bank)
        if self.guard_state is not None:
            tree.append(self.guard_state)
        return tuple(tree)

    def _load_state(self, tree):
        if self._shard_flags is not None:
            shd.mark_shards(tree, self._shard_flags)
        tree = list(tree)
        self.params, self.opt_state = tree[0], tree[1]
        i = 2
        if self.stats_bank is not None:
            self.stats_bank = tree[i]
            i += 1
        if self.guard_state is not None:
            self.guard_state = tree[i]

    def _sync(self):
        """Wait for the card (the reference's ``block_until_ready``): the
        step's kernels run asynchronously, so a span without it times the
        launches, not the work."""
        t = statsbank.first_leaf(self.params)
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)

    def _step_once(self, batch, step):
        args = [self.params, self.opt_state]
        if self.stats_bank is not None:
            args.append(self.stats_bank)
        if self.guard_state is not None:
            args.append(self.guard_state)
        out = list(self.train_step(*args, batch, step))
        self.params, self.opt_state = out[0], out[1]
        i = 2
        if self.stats_bank is not None:
            self.stats_bank = out[i]
            i += 1
        if self.guard_state is not None:
            self.guard_state = out[i]
            i += 1
        return out[i]                        # metrics

    def maybe_resume(self):
        if self.ckpt is None:
            return
        try:
            # step=None walks newest -> oldest, quarantining corrupt dirs
            restored, latest = self.ckpt.restore(self._state_tree())
        except FileNotFoundError:
            return
        self._load_state(restored)
        self.start_step = latest
        if self.lead:
            print(f"[trainer] resumed from step {latest}")

    # -- escalation ladder ---------------------------------------------------
    def _escalate(self, step: int, trips: int, sink) -> int:
        """One rung per consecutive trip; returns the next step to run
        (<= step means a rewind happened)."""
        if trips == 1:
            return step + 1                 # the in-step rejection IS rung 1
        if trips == 2 and self.stats_bank is not None:
            self.stats_bank = statsbank.force_refresh(self.stats_bank)
            sink.emit({"kind": "event", "event": "stats_refresh_forced",
                       "step": step})
            return step + 1
        snap = self.ring.latest() if self.ring is not None else None
        if snap is not None:
            snap_step, tree = snap
            self._load_state(tree)
            sink.emit({"kind": "event", "event": "rollback", "step": step,
                       "to_step": snap_step,
                       "compressed": self.ring.compress})
            return snap_step
        if self.ckpt is not None:
            try:
                restored, s = self.ckpt.restore(self._state_tree())
            except FileNotFoundError:
                return step + 1
            self._load_state(restored)
            sink.emit({"kind": "event", "event": "checkpoint_restore",
                       "step": step, "to_step": s})
            return s
        return step + 1

    def _slowest(self, dt: float) -> float:
        """The step time the watchdog reads: this rank's, or under a mesh
        the slowest rank's (the same verdict on every rank)."""
        if self.mesh is None:
            return dt
        t = torch.tensor([dt], dtype=torch.float64, device=self.mesh.device)
        return float(collectives.all_reduce(t, self.mesh.axis_names,
                                            op="max", mesh=self.mesh)[0])

    def run(self, steps: int, print_fn=print):
        sink = self.sink if self.sink is not None else ConsoleSink(print_fn)
        if not self.lead:
            sink = NullSink()
        watchdog = fault.Watchdog(self.watchdog_factor)
        wd_consecutive = 0
        trips = 0                # consecutive guard trips = ladder rung
        interventions = 0
        step = self.start_step
        while step < steps:
            t_fetch = time.perf_counter()
            batch = self.data_fn(step)
            data_s = time.perf_counter() - t_fetch
            if self.chaos is not None:
                mutated = self.chaos.mutate_bank(step, self.stats_bank)
                if mutated is not None:
                    self.stats_bank = mutated
            self._sync()
            t0 = time.perf_counter()
            if self.chaos is not None:
                # straggler injection lands INSIDE the timed span so the
                # watchdog sees it
                self.chaos.maybe_sleep(step)
            metrics = self._step_once(batch, step)
            self._sync()
            dt = self._slowest(time.perf_counter() - t0)
            metrics = _host_metrics(metrics)
            # straggler watchdog: flag steps > factor x trailing median
            event = watchdog.observe(step, dt)
            if event is not None:
                sink.emit({"kind": "event", "event": "watchdog",
                           "step": step, **event})
                wd_consecutive += 1
                if self.watchdog_escalate_after and \
                        wd_consecutive >= self.watchdog_escalate_after:
                    if self.ring is not None:
                        self.ring.push(step + 1, self._state_tree())
                    sink.emit({"kind": "event", "event": "watchdog_escalated",
                               "step": step, "trips": wd_consecutive,
                               "snapshot": self.ring is not None})
                    wd_consecutive = 0
            else:
                wd_consecutive = 0
            self.history.append(metrics)
            tripped = (self.guard_state is not None
                       and metrics.get("guard_ok", 1.0) < 0.5)
            if tripped:
                trips += 1
                interventions += 1
                cause = ",".join(c for c in ("nonfinite", "spike", "sat",
                                             "forced")
                                 if metrics.get(f"guard_{c}", 0.0) >= 0.5)
                sink.emit({"kind": "event", "event": "guard_tripped",
                           "step": step, "trip": trips,
                           "cause": cause or "unknown",
                           "loss": metrics.get("loss"),
                           "grad_norm": metrics.get("grad_norm")})
                if interventions > self.max_interventions:
                    sink.flush()
                    raise RuntimeError(
                        f"StepGuard: {interventions} interventions without "
                        f"recovery (last trip at step {step}, cause "
                        f"{cause or 'unknown'}) — giving up")
                next_step = self._escalate(step, trips, sink)
                if next_step <= step:
                    trips = 0               # rewound: the ladder restarts
                step = next_step
                continue
            trips = 0
            if self.ring is not None and self.snapshot_every and \
                    (step + 1) % self.snapshot_every == 0:
                # the state ENTERING step+1 — last-good by construction
                # (this step just passed the guard)
                self.ring.push(step + 1, self._state_tree())
            t1 = time.perf_counter()
            saved = False
            if self.ckpt is not None and self.ckpt_every and \
                    (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, self._state_tree(), blocking=False)
                saved = True
            ckpt_s = time.perf_counter() - t1
            if saved:
                sink.emit({"kind": "event", "event": "checkpoint_saved",
                           "step": step + 1, "blocking_s": ckpt_s,
                           "write_s": getattr(self.ckpt,
                                              "last_write_seconds", 0.0)})
            if self.chaos is not None and self.ckpt is not None:
                damage = self.chaos.corrupt_checkpoint(step, self.ckpt)
                if damage is not None:
                    sink.emit({"kind": "event",
                               "event": "chaos_corrupt_ckpt",
                               "step": step, **damage})
            if self.log_every and step % self.log_every == 0:
                refreshed = bool(metrics.get("stats_refreshed", 0.0))
                sink.emit({"kind": "train_step", "step": step,
                           "loss": metrics["loss"], "lr": metrics["lr"],
                           "grad_norm": metrics.get("grad_norm"),
                           "data_ms": data_s * 1e3, "step_ms": dt * 1e3,
                           "ckpt_ms": ckpt_s * 1e3 if saved else 0.0,
                           "refresh_ms": dt * 1e3 if refreshed else 0.0,
                           **{k: metrics[k] for k in ("aux", "probe_stats")
                              if k in metrics}})
            step += 1
        if self.ckpt is not None:
            self.ckpt.wait()
        sink.flush()
        return self.history
