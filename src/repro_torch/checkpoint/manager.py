"""Fault-tolerant checkpoint manager (port of
``repro.checkpoint.manager``), byte-compatible with the reference's
files: a checkpoint written by either package restores in the other.

Layout of ``<dir>/step_<N:010d>/``: one ``leaf_<i:05d>.npy`` per leaf in
JAX's ``tree_flatten`` order (``convert.jax_leaves``: dict keys sorted,
``OptState`` as (step, m, v) with ``step`` a 0-d int32, ``None`` no
leaf), ``META.json`` (``step``, ``n_leaves``, ``compress``, each leaf's
kind) and ``MANIFEST.json`` (each file's CRC32 and size).

  * atomic: write ``step_<N>.tmp/`` then ``os.rename`` — the rename is
    the commit point; restore scans for the newest complete step.
  * S2FP8 compression (``compress=True``): f32 leaves of rank >= 2 and at
    least 4,096 elements are stored as their 1-byte e5m2 payload
    (``leaf_<i>.payload.npy``, uint8) and (alpha, beta)
    (``leaf_<i>.stats.npy``); the codec runs on the leaf's device through
    the numerics engine ``backend`` (on the card: the quantize-with-stats
    kernel on ``cuda_fused``, the torch stats and quantize-apply on
    ``cuda``, the dequantize kernel on restore), and only the payload and
    the stats cross to the host.  Smaller leaves stay raw, bit-exact.
  * retention: keep the newest ``keep`` checkpoints (GC after each write).
  * async flush: ``save(..., blocking=False)`` hands the host copies to
    one writer thread.  The copies are complete when ``save`` returns
    (synchronous device-to-host copies), so the next step may write into
    the same tensors — the optimizer updates in place.

Hardening:

  * integrity: ``restore`` validates a step directory against its
    manifest first — a truncated leaf, a flipped bit or a missing manifest
    all fail closed.
  * quarantine: a directory that fails is renamed
    ``step_<N>.quarantined`` (kept for post-mortem, invisible to every
    scan) with a ``checkpoint_quarantined`` event through ``event_fn``;
    ``restore(step=None)`` falls back to the next-newest valid step.
  * transient-I/O retry: every write and read attempt retries up to
    ``retries`` times on OSError with exponential backoff and jitter.

Under a mesh (``mesh=``, a ``launch/mesh.py`` :class:`Mesh`; every rank
makes the same calls): ``save`` gathers the FSDP-sharded leaves to full
ones (``sharding.gather_tree``), rank 0 writes, and the ranks meet at a
barrier; ``restore`` lets rank 0 pick the step (validating and
quarantining as above), tells the other ranks which, and every rank reads
the full leaves and cuts its own shards (``sharding.reshard_like``).  The
files are the meshless ones, so a checkpoint moves between any number of
ranks and any sharding mode.
"""
from __future__ import annotations

import json
import os
import random
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import backend as nbackend
from repro_torch.core.s2fp8 import S2FP8Tensor

MANIFEST = "MANIFEST.json"
# the codec's leaves: f32, rank >= 2, at least this many elements
COMPRESS_MIN_SIZE = 4096


def compressible(leaf) -> bool:
    """Whether the S2FP8 codec takes ``leaf`` (the reference's rule)."""
    return (isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32
            and leaf.dim() >= 2 and leaf.numel() >= COMPRESS_MIN_SIZE)


def encode(leaf: torch.Tensor, backend: Optional[str] = None
           ) -> Tuple[np.ndarray, np.ndarray]:
    """S2FP8 (e5m2, the leaf's exact stats) on the leaf's device: (the
    payload's bytes as uint8, (alpha, beta) as f32), on the host."""
    t = nbackend.get_backend(backend).quantize(leaf.detach())
    return (t.payload.view(torch.uint8).cpu().numpy(),
            t.ab.cpu().numpy().astype(np.float32))


def decode(payload: np.ndarray, stats: np.ndarray, device,
           dtype=torch.float32, backend: Optional[str] = None
           ) -> torch.Tensor:
    """The values of an :func:`encode` result, on ``device``."""
    p = torch.from_numpy(np.ascontiguousarray(payload)).to(device)
    ab = torch.from_numpy(np.asarray(stats, np.float32)).to(device)
    t = S2FP8Tensor(p.view(torch.float8_e5m2), ab)
    return nbackend.get_backend(backend).dequantize(t).to(dtype)


def host_copy(leaf) -> np.ndarray:
    """A numpy copy of ``leaf`` that no later in-place update reaches."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _step_of(name: str) -> Optional[int]:
    """step_0000000012 -> 12; anything else (tmp, quarantined, stray
    files) -> None.  The single parser every directory scan goes through."""
    if not name.startswith("step_"):
        return None
    digits = name[len("step_"):]
    return int(digits) if digits.isdigit() else None


def _file_crc(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return crc
            crc = zlib.crc32(buf, crc)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, compress: bool = False,
                 retries: int = 3, backoff_s: float = 0.05,
                 event_fn: Optional[Callable[[Dict[str, Any]], None]] = None,
                 backend: Optional[str] = None, mesh=None):
        self.dir = directory
        self.mesh = mesh
        self.keep = keep
        self.compress = compress
        self.retries = max(int(retries), 1)
        self.backoff_s = backoff_s
        # structured-event hook (TrainLoop wires its sink's emit here)
        self.event_fn = event_fn
        self.backend = backend
        os.makedirs(directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        # wall-clock of the most recently COMPLETED disk write (async
        # writes included); TrainLoop's "checkpoint_saved" events read it
        self.last_write_seconds: float = 0.0

    def _emit(self, record: Dict[str, Any]):
        if self.event_fn is not None:
            self.event_fn(record)

    def _with_retry(self, fn, what: str):
        """Run ``fn`` with exponential backoff + jitter on OSError; the last
        failure re-raises.  Corruption is not retried (it goes through
        validation and quarantine)."""
        for attempt in range(self.retries):
            try:
                return fn()
            except OSError:
                if attempt == self.retries - 1:
                    raise
                delay = self.backoff_s * (2 ** attempt)
                time.sleep(delay * (1.0 + random.random()))

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _host_leaf(self, leaf):
        """("s2fp8", payload, stats, shape) or ("raw", array), on the host."""
        if self.compress and compressible(leaf):
            payload, stats = encode(leaf, self.backend)
            return ("s2fp8", payload, stats, list(leaf.shape))
        return ("raw", host_copy(leaf))

    def _lead(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _barrier(self, value: float = 0.0) -> float:
        """Every rank meets here; returns the max of ``value`` over them
        (how rank 0's pick reaches the others)."""
        from repro_torch.core import collectives
        t = torch.tensor([value], dtype=torch.float64,
                         device=self.mesh.device)
        return float(collectives.all_reduce(t, self.mesh.axis_names,
                                            op="max", mesh=self.mesh)[0])

    def save(self, step: int, tree: Any, blocking: bool = True):
        if self.mesh is not None:
            from repro_torch.parallel import sharding
            tree = sharding.gather_tree(tree, self.mesh)
            if not self._lead():
                self._barrier()
                return
        try:
            self._save(step, tree, blocking)
        finally:
            if self.mesh is not None:
                self._barrier()

    def _save(self, step: int, tree: Any, blocking: bool):
        # host copies first, complete before save returns
        host = [self._host_leaf(x) for x in convert.jax_leaves(tree)]
        if self._writer is not None:
            self._writer.join()          # backpressure: one in-flight write
            self._writer = None

        def write_once():
            tmp = self._step_dir(step) + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            meta = {"step": step, "n_leaves": len(host),
                    "compress": self.compress}
            files = []
            for i, entry in enumerate(host):
                if entry[0] == "s2fp8":
                    _, payload, stats, shape = entry
                    files.append(f"leaf_{i:05d}.payload.npy")
                    np.save(os.path.join(tmp, files[-1]), payload)
                    files.append(f"leaf_{i:05d}.stats.npy")
                    np.save(os.path.join(tmp, files[-1]), stats)
                    meta[f"leaf_{i}"] = {"kind": "s2fp8", "shape": shape}
                else:
                    files.append(f"leaf_{i:05d}.npy")
                    np.save(os.path.join(tmp, files[-1]), entry[1])
                    meta[f"leaf_{i}"] = {"kind": "raw"}
            manifest = {"files": {
                name: {"crc32": _file_crc(os.path.join(tmp, name)),
                       "size": os.path.getsize(os.path.join(tmp, name))}
                for name in files}}
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "META.json"), "w") as f:
                json.dump(meta, f)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)        # commit point

        def write():
            t0 = time.perf_counter()
            self._with_retry(write_once, f"save step {step}")
            self._gc()
            self.last_write_seconds = time.perf_counter() - t0

        if blocking:
            write()
        else:
            self._writer = threading.Thread(target=write, daemon=True)
            self._writer.start()

    def wait(self):
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    # ------------------------------------------------------------------
    # integrity
    # ------------------------------------------------------------------
    def validate(self, step: int) -> Tuple[bool, str]:
        """Check a committed step dir against its manifest: META present,
        MANIFEST present, every listed file present with matching size and
        CRC32.  A dir without a manifest fails closed."""
        d = self._step_dir(step)
        if not os.path.exists(os.path.join(d, "META.json")):
            return False, "missing META.json"
        mpath = os.path.join(d, MANIFEST)
        if not os.path.exists(mpath):
            return False, "missing manifest"
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return False, "unreadable manifest"
        for name, info in manifest.get("files", {}).items():
            path = os.path.join(d, name)
            if not os.path.exists(path):
                return False, f"missing file {name}"
            if os.path.getsize(path) != info["size"]:
                return False, f"size mismatch {name}"
            if _file_crc(path) != info["crc32"]:
                return False, f"checksum mismatch {name}"
        return True, "ok"

    def quarantine(self, step: int, reason: str):
        """Rename a corrupt step dir out of the scan namespace (kept on
        disk for post-mortem) and emit ``checkpoint_quarantined``."""
        src = self._step_dir(step)
        dst = src + ".quarantined"
        if os.path.exists(dst):
            shutil.rmtree(dst, ignore_errors=True)
        os.rename(src, dst)
        self._emit({"kind": "event", "event": "checkpoint_quarantined",
                    "step": step, "reason": reason, "path": dst})

    # ------------------------------------------------------------------
    def _committed_steps(self):
        steps = []
        for name in os.listdir(self.dir):
            s = _step_of(name)
            if s is not None and os.path.exists(
                    os.path.join(self.dir, name, "META.json")):
                steps.append(s)
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self._committed_steps()
        return max(steps) if steps else None

    def restore(self, template: Any, step: Optional[int] = None
                ) -> Tuple[Any, int]:
        """Restore into the structure of ``template`` (new tensors on its
        leaves' devices).

        ``step=None`` walks committed checkpoints newest -> oldest,
        validating each against its manifest; corrupt dirs are
        quarantined (with a ``checkpoint_quarantined`` event) and the
        walk continues — the caller gets the newest VALID state or
        FileNotFoundError when none survives.  An explicit ``step`` is
        validated the same way but raises instead of falling back.  Under
        a mesh, ``template`` is this rank's (sharded) tree."""
        if self.mesh is None:
            return self._restore(template, step)
        from repro_torch.parallel import sharding
        full = sharding.full_template(template, self.mesh)
        # rank 0's pick wins the max: the other ranks offer -1e18
        tree, got = None, -1e18
        if self._lead():
            try:
                tree, got = self._restore(full, step)
            except FileNotFoundError:
                got = -1.0
            except ValueError:
                got = -2.0
        got = int(self._barrier(got))
        if got == -1:
            raise FileNotFoundError(f"no valid checkpoint in {self.dir}")
        if got == -2:
            raise ValueError(f"checkpoint step {step} failed validation")
        if tree is None:
            tree = self._read(full, got)
        return sharding.reshard_like(tree, template, self.mesh), got

    def _restore(self, template: Any, step: Optional[int]
                 ) -> Tuple[Any, int]:
        if step is not None:
            ok, reason = self.validate(step)
            if not ok:
                raise ValueError(
                    f"checkpoint step {step} failed validation: {reason}")
            return self._read(template, step), step
        for s in reversed(self._committed_steps()):
            ok, reason = self.validate(s)
            if not ok:
                self.quarantine(s, reason)
                continue
            try:
                return self._read(template, s), s
            except (OSError, ValueError) as e:
                # readable manifest but unreadable data (or a template
                # mismatch from a stale run) — same fallback path
                self.quarantine(s, f"read failed: {e}")
        raise FileNotFoundError(f"no valid checkpoint in {self.dir}")

    def _read(self, template: Any, step: int) -> Any:
        d = self._step_dir(step)
        with open(os.path.join(d, "META.json")) as f:
            meta = json.load(f)
        leaves = convert.jax_leaves(template)
        if meta["n_leaves"] != len(leaves):
            raise ValueError(
                f"checkpoint has {meta['n_leaves']} leaves, template "
                f"{len(leaves)}")
        out = []
        for i, tmpl in enumerate(leaves):
            info = meta[f"leaf_{i}"]
            if info["kind"] == "s2fp8":
                payload = self._with_retry(
                    lambda p=os.path.join(d, f"leaf_{i:05d}.payload.npy"):
                    np.load(p), "read payload")
                stats = self._with_retry(
                    lambda p=os.path.join(d, f"leaf_{i:05d}.stats.npy"):
                    np.load(p), "read stats")
                device = (tmpl.device if isinstance(tmpl, torch.Tensor)
                          else torch.device("cpu"))
                dtype = (tmpl.dtype if isinstance(tmpl, torch.Tensor)
                         else torch.float32)
                out.append(decode(payload.reshape(info["shape"]), stats,
                                  device, dtype, self.backend))
            else:
                out.append(self._with_retry(
                    lambda p=os.path.join(d, f"leaf_{i:05d}.npy"):
                    np.load(p), "read leaf"))
        return convert.unflatten(template, out)

    def _gc(self):
        if not self._lead():
            return
        for s in self._committed_steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
