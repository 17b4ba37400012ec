"""Meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A :class:`Mesh` names the axes of a ``torch.distributed`` device mesh
(``init_device_mesh``): one rank per device, laid out row-major over the
axes.  It exposes ``axis_names``, ``shape`` (name -> size), a process group
per axis (``groups``) and this rank's coordinate on each axis
(``coords``).  Axis contract, as the reference's: ``data`` carries the
batch and, under the launchers' ``--shard-params`` FSDP modes, the param
and optimizer shards; ``model`` is the tensor-parallel axis, which the
mesh-native train step replicates over; ``pod`` carries the batch across
pods.

The process group comes first: :func:`init_distributed` reads ``RANK`` /
``WORLD_SIZE`` (and ``MASTER_ADDR`` / ``MASTER_PORT``) as ``torchrun``
sets them, or makes a 1-rank group when they are absent.  It uses NCCL on
``cuda`` and gloo on ``cpu``, with no fallback: a failed NCCL
initialization raises.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Dict, Sequence

import torch
import torch.distributed as dist

from repro_torch import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
TIMEOUT_S = 600.0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device=None) -> torch.device:
    """Initialize the default process group for ``device`` (default
    ``cuda``) unless one exists, and return the device this rank runs on
    (``cuda:<LOCAL_RANK>`` on a card).  Rank, world size and rendezvous
    come from ``torchrun``'s environment, else it is a 1-rank group on a
    free ``localhost`` port.  NCCL on ``cuda``, gloo on ``cpu``; a
    collective that waits longer than ``TIMEOUT_S`` raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", dev.index if dev.index is not None
                           else local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        want = BACKENDS[dev.type]
        if dist.get_backend() != want:
            raise RuntimeError(f"a {dist.get_backend()} process group is "
                               f"already up; {dev} needs {want}")
        return dev
    rank = int(os.environ.get("RANK", "0"))
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        init_method = "env://"
    elif world_size == 1:
        init_method = f"tcp://localhost:{_free_port()}"
    else:
        raise RuntimeError("a multi-rank group needs MASTER_ADDR / "
                           "MASTER_PORT (torchrun)")
    kw = {}
    if dev.type == "cuda":
        kw["device_id"] = dev
    dist.init_process_group(
        BACKENDS[dev.type], init_method=init_method, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    return dev


class Mesh:
    """Named axes over the world's ranks (``init_device_mesh``)."""

    def __init__(self, dims: Sequence[int], axis_names: Sequence[str]):
        if not dist.is_initialized():
            raise RuntimeError("build a mesh after init_distributed()")
        dims = tuple(int(d) for d in dims)
        axis_names = tuple(axis_names)
        if len(dims) != len(axis_names):
            raise ValueError(f"{len(dims)} dims for axes {axis_names}")
        n = 1
        for d in dims:
            n *= d
        world = dist.get_world_size()
        if n != world:
            raise ValueError(f"mesh {dict(zip(axis_names, dims))} needs "
                             f"{n} ranks; the world has {world}")
        from torch.distributed.device_mesh import init_device_mesh
        self.device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.device_mesh = init_device_mesh(self.device_type, dims,
                                            mesh_dim_names=axis_names)
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, dims))
        self.groups = {a: self.device_mesh.get_group(a) for a in axis_names}
        self.coords = {a: self.device_mesh.get_local_rank(a)
                       for a in axis_names}
        self.rank = dist.get_rank()
        self.size = world
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if self.device_type == "cuda"
                       else torch.device("cpu"))

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank}, coords {self.coords})"


class DryMesh:
    """A mesh's axis names and sizes with no process group behind them, for
    dry traces (``launch/dryrun.py``): this process stands for rank 0
    (coordinate 0 on every axis), and ``core/collectives.py``'s
    primitives record each collective and return a tensor of its result's
    shape without communicating (``groups`` is None)."""

    groups = None

    def __init__(self, dims: Sequence[int], axis_names: Sequence[str],
                 device="cpu"):
        dims = tuple(int(d) for d in dims)
        self.axis_names = tuple(axis_names)
        if len(dims) != len(self.axis_names):
            raise ValueError(f"{len(dims)} dims for axes {self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, dims))
        self.coords = {a: 0 for a in self.axis_names}
        self.rank = 0
        self.size = 1
        for d in dims:
            self.size *= d
        self.device = torch.device(device)
        self.device_type = self.device.type

    def __repr__(self):
        return f"DryMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False, dry: bool = False):
    """16 x 16 single pod (256 ranks) or 2 x 16 x 16 two-pod (512); raises
    unless the world has that many ranks.  ``dry=True``: a
    :class:`DryMesh` of those sizes (no process group)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return DryMesh(shape, axes) if dry else Mesh(shape, axes)


def make_host_mesh() -> Mesh:
    """Every rank of the world on the ``data`` axis, 1 on ``model``."""
    return Mesh((dist.get_world_size(), 1), ("data", "model"))


def parse_mesh_spec(spec: str):
    """(dims, axis names) of a ``"DxT"`` / ``"PxDxT"`` spec, with the
    reference's errors."""
    try:
        dims = tuple(int(p) for p in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh spec {spec!r} is not of the form 'DxT' "
                         f"or 'PxDxT' (e.g. '8x1')") from None
    if len(dims) == 2:
        axes = ("data", "model")
    elif len(dims) == 3:
        axes = ("pod", "data", "model")
    else:
        raise ValueError(f"mesh spec {spec!r}: want 2 (DxT) or 3 (PxDxT) "
                         f"factors, got {len(dims)}")
    return dims, axes


def make_mesh_from_spec(spec: str) -> Mesh:
    """``"DxT"`` builds a ``("data", "model")`` mesh, ``"PxDxT"`` a
    ``("pod", "data", "model")`` one; the product must be the world
    size."""
    return Mesh(*parse_mesh_spec(spec))


def axis_sizes(mesh) -> dict:
    return dict(mesh.shape)
