"""Deterministic fault injection (port of ``repro.training.chaos``) — the
harness that proves the guardrails.

``launch/train.py --chaos <spec>`` arms a :class:`ChaosPlan`.  Spec
grammar::

    spec    := item ("," item)*
    item    := name "@" step ("x" count)? (":" param)?

    nan_grad@5          NaN into every grad leaf at step 5
    inf_loss@5          loss := +inf at step 5
    reject@5            force the guard verdict to reject at step 5
    nan_grad@5x3        ... at steps 5, 6 and 7 (count consecutive steps)
    saturating_bank@8   sat_frac := 1.0 on every telemetry leaf before
                        step 8 (stale/saturating carried stats)
    corrupt_ckpt@10     corrupt the newest on-disk checkpoint after step
                        10; param picks the flavor — :truncate (default),
                        :bitflip, :manifest (delete MANIFEST.json)
    slow_step@12:0.5    sleep 0.5 s inside step 12's timed span (straggler
                        for the watchdog; default 0.75 s)
    corrupt_batch@3     zero every int leaf / NaN every float leaf of
                        step 3's batch

Two delivery channels:

* **In the step** (nan_grad / inf_loss / reject): the schedule travels
  in ``batch["_chaos"]`` (the fault step, or -1, for every injector), and
  the train step pops it and injects where the reference does: after the
  loss is scaled back, before the guard.  The port runs eagerly, so the
  fields are host ints and an injector that does not fire costs nothing.
* **Host-side** (saturating_bank / corrupt_ckpt / slow_step /
  corrupt_batch): hooks TrainLoop calls at the matching point in the
  step lifecycle.

Every event is SINGLE-FIRE: once delivered it is spent, so a rollback
that rewinds past step t replays t clean instead of re-injecting.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

# injectors delivered as batch["_chaos"] data (see module docstring)
IN_TRACE = ("nan_grad", "inf_loss", "reject")
HOST_SIDE = ("saturating_bank", "corrupt_ckpt", "slow_step", "corrupt_batch")
NAMES = IN_TRACE + HOST_SIDE


@dataclasses.dataclass
class ChaosEvent:
    name: str
    step: int
    param: Optional[str] = None
    fired: bool = False


def parse_spec(spec: str) -> List[ChaosEvent]:
    """Parse the grammar above; ``xN`` expands to N consecutive steps
    (consecutive faults are how the ladder is driven past its first rung)."""
    events: List[ChaosEvent] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "@" not in item:
            raise ValueError(f"chaos item {item!r}: expected name@step")
        name, _, rest = item.partition("@")
        name = name.strip()
        if name not in NAMES:
            raise ValueError(f"unknown chaos injector {name!r} "
                             f"(known: {', '.join(NAMES)})")
        param = None
        if ":" in rest:
            rest, _, param = rest.partition(":")
        count = 1
        if "x" in rest:
            rest, _, cnt = rest.partition("x")
            count = int(cnt)
            if count < 1:
                raise ValueError(f"chaos item {item!r}: count must be >= 1")
        step = int(rest)
        if step < 0:
            raise ValueError(f"chaos item {item!r}: step must be >= 0")
        for k in range(count):
            events.append(ChaosEvent(name, step + k, param))
    return events


class ChaosPlan:
    """The armed schedule plus its fired-state; one per run."""

    def __init__(self, events: List[ChaosEvent]):
        self.events = list(events)

    @classmethod
    def parse(cls, spec: str) -> "ChaosPlan":
        return cls(parse_spec(spec))

    def _take(self, name: str, step: int) -> Optional[ChaosEvent]:
        """Pop-semantics lookup: the unfired event for (name, step), marked
        fired — the single-shot contract."""
        for e in self.events:
            if e.name == name and e.step == step and not e.fired:
                e.fired = True
                return e
        return None

    # -- in-step channel ----------------------------------------------------
    def batch_fields(self, step: int) -> Dict[str, int]:
        """The ``batch["_chaos"]`` payload for ``step``: every in-step
        injector always present, value = this step if it fires now else
        -1."""
        return {name: step if self._take(name, step) is not None else -1
                for name in IN_TRACE}

    # -- host-side hooks (TrainLoop lifecycle order) ------------------------
    def corrupt_batch(self, step: int, batch: Any) -> Any:
        if self._take("corrupt_batch", step) is None:
            return batch

        def garble(x):
            if isinstance(x, dict):
                return {k: garble(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(garble(v) for v in x)
            if x.is_floating_point():
                return torch.full_like(x, float("nan"))
            return torch.zeros_like(x)

        return garble(batch)

    def mutate_bank(self, step: int, bank: Optional[Dict[str, Any]]
                    ) -> Optional[Dict[str, Any]]:
        """saturating_bank: pin every ``sat_frac`` telemetry leaf at 1.0 —
        the signature of carried (alpha, beta) gone stale enough that the
        whole tensor lands past the format max.  Returns the mutated bank
        (a new one) or None (no event / no bank / no telemetry leaves)."""
        if bank is None or self._take("saturating_bank", step) is None:
            return None
        mutated, hit = {}, False
        for site, entry in bank.items():
            mutated[site] = {}
            for d, st in entry.items():
                if "sat_frac" in st:
                    hit = True
                    mutated[site][d] = dict(
                        st, sat_frac=torch.full_like(st["sat_frac"], 1.0))
                else:
                    mutated[site][d] = st
        return mutated if hit else None

    def sleep_s(self, step: int) -> float:
        e = self._take("slow_step", step)
        if e is None:
            return 0.0
        return float(e.param) if e.param else 0.75

    def maybe_sleep(self, step: int) -> float:
        dt = self.sleep_s(step)
        if dt > 0:
            time.sleep(dt)
        return dt

    def corrupt_checkpoint(self, step: int, manager
                           ) -> Optional[Dict[str, Any]]:
        """corrupt_ckpt: damage the newest COMMITTED checkpoint dir.
        Flavors: truncate the first leaf file (default), flip a byte
        (:bitflip — the checksum must catch it), or delete the manifest
        (:manifest).  Returns a description of what was damaged, None if
        no event fired or there is nothing on disk yet."""
        e = self._take("corrupt_ckpt", step)
        if e is None:
            return None
        manager.wait()                      # damage a finished write only
        latest = manager.latest_step()
        if latest is None:
            return None
        d = manager._step_dir(latest)
        flavor = e.param or "truncate"
        if flavor == "manifest":
            path = os.path.join(d, "MANIFEST.json")
            if os.path.exists(path):
                os.remove(path)
            return {"ckpt_step": latest, "flavor": flavor, "file": path}
        leaves = sorted(n for n in os.listdir(d) if n.endswith(".npy"))
        if not leaves:
            return None
        path = os.path.join(d, leaves[0])
        if flavor == "bitflip":
            with open(path, "r+b") as f:
                f.seek(-1, 2)
                byte = f.read(1)
                f.seek(-1, 2)
                f.write(bytes([byte[0] ^ 0xFF]))
        else:                               # truncate
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(size // 2, 1))
        return {"ckpt_step": latest, "flavor": flavor, "file": path}


def wrap_data_fn(data_fn: Callable[[int], Any], plan: Optional[ChaosPlan]
                 ) -> Callable[[int], Any]:
    """Attach the in-step schedule (and batch corruption) to a data_fn.
    With ``plan=None`` the batch is returned untouched."""
    if plan is None:
        return data_fn

    def fn(step: int):
        batch = plan.corrupt_batch(step, data_fn(step))
        batch = dict(batch)
        batch["_chaos"] = plan.batch_fields(step)
        return batch

    return fn


# ---------------------------------------------------------------------------
# in-step injection points (called from trainer.py)
# ---------------------------------------------------------------------------

def split_batch(batch: Any) -> Tuple[Any, Optional[Dict[str, int]]]:
    """Pop the ``_chaos`` schedule off the batch (None when absent)."""
    if not isinstance(batch, dict) or "_chaos" not in batch:
        return batch, None
    batch = dict(batch)
    return batch, batch.pop("_chaos")


def _fires(chaos: Optional[Dict[str, int]], name: str, step) -> bool:
    return chaos is not None and int(chaos.get(name, -1)) == int(step)


def inject_loss(chaos, loss: torch.Tensor, step) -> torch.Tensor:
    if not _fires(chaos, "inf_loss", step):
        return loss
    return torch.full_like(loss, float("inf"))


def inject_grads(chaos, grads, step):
    """``grads`` (a list of tensors) with every leaf NaN when nan_grad
    fires at ``step``."""
    if not _fires(chaos, "nan_grad", step):
        return grads
    return [torch.full_like(g, float("nan")) for g in grads]


def forced_reject(chaos, step) -> Optional[bool]:
    """True / False when the schedule is armed, None when there is none."""
    if chaos is None:
        return None
    return _fires(chaos, "reject", step)
