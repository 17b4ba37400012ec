"""Per-leaf device-memory residency planner for the FSDP param-sharding
modes (port of ``repro.launch.memplan``).

Answers "does this arch's param + optimizer store fit per card?" without
running anything, by applying the trainer's sharding and eligibility rules
(parallel/sharding.py) to the param tree:

  * ``replicated`` — every rank stores the full f32 master and both AdamW
    moments: 12 bytes an element.
  * ``fsdp``       — eligible leaves (float, dim 0 divisible by the fsdp
    axis) store 1/n_shards of that, plus a transient full-size f32
    all-gather (4 bytes an element) while the leaf is in use.
  * ``fsdp_q``     — the same sharded store, but payload-eligible leaves
    (rank 2, the GEMM B slots) gather as S2FP8 payloads: 1 byte an
    element + 8 bytes of (alpha, beta).

The gather term is reported as a per-leaf peak (one gathered leaf live)
and as a sum (every gathered leaf live).  Activations are out of scope.
The shape arithmetic is the reference's; :func:`plan_arch` builds the
params and the AdamW state as fake tensors (meta storage: shapes and
dtypes, no memory) instead of JAX's ``eval_shape``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Tuple

# one NVIDIA H100 80GB HBM3, 700 W (the port's card)
HBM_PER_CHIP_GB = 80.0
PAYLOAD_STATS_BYTES = 8       # f32 (alpha, beta) per payload leaf
MODES = ("replicated", "fsdp", "fsdp_q")

_FLOAT_DTYPES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


def _dtype_name(dtype) -> str:
    # torch dtypes print as "torch.float32"; numpy dtypes have .name
    name = (getattr(dtype, "name", None)
            or getattr(dtype, "__name__", None) or str(dtype))
    return name.replace("torch.", "")


def _itemsize(dtype) -> int:
    name = _dtype_name(dtype)
    if name in _FLOAT_DTYPES:
        return _FLOAT_DTYPES[name]
    if "int8" in name or "uint8" in name or "bool" in name:
        return 1
    if "16" in name:
        return 2
    if "64" in name:
        return 8
    return 4


def leaf_eligible(shape: Tuple[int, ...], dtype, n_shards: int) -> bool:
    """``sharding.fsdp_leaf_eligible`` on a shape and dtype name: float,
    rank >= 1, dim 0 divisible by the fsdp axis size."""
    if _dtype_name(dtype) not in _FLOAT_DTYPES:
        return False
    if len(shape) == 0 or shape[0] == 0:
        return False
    return shape[0] % n_shards == 0


def payload_eligible(shape: Tuple[int, ...], dtype, n_shards: int) -> bool:
    """The trainer streams payloads only for rank-2 eligible leaves."""
    return leaf_eligible(shape, dtype, n_shards) and len(shape) == 2


@dataclasses.dataclass
class LeafPlan:
    n_elements: int
    store_bytes: int          # per-rank persistent store (one copy)
    gather_bytes: int         # transient full-size residency while live
    sharded: bool
    payload: bool


def plan_leaf(shape: Tuple[int, ...], dtype, n_shards: int,
              mode: str) -> LeafPlan:
    """Byte plan for one param (or moment) leaf under a sharding mode."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    n = int(math.prod(shape)) if shape else 1
    item = _itemsize(dtype)
    elig = n_shards > 1 and leaf_eligible(shape, dtype, n_shards) \
        and mode != "replicated"
    pay = elig and mode == "fsdp_q" and payload_eligible(shape, dtype,
                                                        n_shards)
    store = n * item // n_shards if elig else n * item
    if not elig:
        gather = 0                       # already resident full-size
    elif pay:
        gather = n * 1 + PAYLOAD_STATS_BYTES
    else:
        gather = n * item
    return LeafPlan(n_elements=n, store_bytes=store, gather_bytes=gather,
                    sharded=elig, payload=pay)


def plan_leaves(leaves: Iterable[Tuple[Tuple[int, ...], object]],
                n_shards: int, mode: str,
                with_gather: bool = True) -> Dict[str, int]:
    """Aggregate plan over (shape, dtype) leaves; ``with_gather=False``
    for optimizer moments (updated shard-local, never gathered)."""
    out = {"store_bytes": 0, "gather_peak_bytes": 0, "gather_sum_bytes": 0,
           "n_leaves": 0, "n_sharded": 0, "n_payload": 0}
    for shape, dtype in leaves:
        lp = plan_leaf(tuple(shape), dtype, n_shards, mode)
        out["store_bytes"] += lp.store_bytes
        if with_gather:
            out["gather_peak_bytes"] = max(out["gather_peak_bytes"],
                                           lp.gather_bytes)
            out["gather_sum_bytes"] += lp.gather_bytes
        out["n_leaves"] += 1
        out["n_sharded"] += int(lp.sharded)
        out["n_payload"] += int(lp.payload)
    return out


def _tree_leaves(tree):
    """(shape, dtype) of every leaf of a port tree in JAX's leaf order
    (``convert.jax_leaves``: the ``OptState`` step counter is a 0-d int32,
    as in the reference's tree)."""
    from repro_torch import convert
    out = []
    for leaf in convert.jax_leaves(tree):
        shape = tuple(getattr(leaf, "shape", ()))
        out.append((shape, leaf.dtype))
    return out


def plan_state(param_tree, opt_tree, n_shards: int, mode: str) -> dict:
    """Param + optimizer plan for one rank: ``steady_bytes`` (params +
    moments) and ``peak_bytes`` (steady + the largest single gather)."""
    p = plan_leaves(_tree_leaves(param_tree), n_shards, mode)
    o = plan_leaves(_tree_leaves(opt_tree), n_shards, mode,
                    with_gather=False)
    steady = p["store_bytes"] + o["store_bytes"]
    return {
        "mode": mode, "n_shards": n_shards,
        "param_store_bytes": p["store_bytes"],
        "opt_store_bytes": o["store_bytes"],
        "steady_bytes": steady,
        "gather_peak_bytes": p["gather_peak_bytes"],
        "gather_sum_bytes": p["gather_sum_bytes"],
        "peak_bytes": steady + p["gather_peak_bytes"],
        "n_leaves": p["n_leaves"], "n_sharded": p["n_sharded"],
        "n_payload": p["n_payload"],
    }


def fsdp_shards_of(axis_sizes: Dict[str, int]) -> int:
    """fsdp-axis size of a mesh's {axis: size} (``data`` carries fsdp)."""
    return int(axis_sizes.get("data", 1))


def arch_state(arch: str):
    """(params, AdamW state) of ``arch`` at full size as fake tensors
    (``api.param_struct``): shapes and dtypes on meta storage, no
    memory."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import api
    from repro_torch.optim import optimizers
    params = api.param_struct(get_config(arch))
    with api.fake_mode():
        opt = optimizers.adamw().init(params)
    return params, opt


def plan_arch(arch: str, n_shards: int, mode: str = "fsdp_q",
              hbm_gb: float = HBM_PER_CHIP_GB) -> dict:
    """Plan one arch's train-time store (f32 masters + AdamW moments) and
    the fits-or-not verdict against ``hbm_gb`` GiB a card."""
    params, opt = arch_state(arch)
    plan = plan_state(params, opt, n_shards, mode)
    plan["arch"] = arch
    plan["hbm_gb"] = hbm_gb
    plan["fits"] = plan["peak_bytes"] <= hbm_gb * 2**30
    return plan


def format_report(archs, axis_sizes: Dict[str, int],
                  hbm_gb: float = HBM_PER_CHIP_GB) -> str:
    """Residency table (GB a rank) across all three modes per arch."""
    n = fsdp_shards_of(axis_sizes)
    gb = 2**30
    lines = [f"[memplan] fsdp axis: {n}-way 'data' "
             f"({dict(axis_sizes)}), HBM {hbm_gb:.0f} GB/card",
             f"{'arch':<22}{'mode':<12}{'params':>9}{'opt':>9}"
             f"{'gather':>9}{'peak':>9}  fits"]
    for arch in archs:
        for mode in MODES:
            p = plan_arch(arch, n, mode, hbm_gb)
            lines.append(
                f"{arch:<22}{mode:<12}"
                f"{p['param_store_bytes'] / gb:>8.2f}G"
                f"{p['opt_store_bytes'] / gb:>8.2f}G"
                f"{p['gather_peak_bytes'] / gb:>8.2f}G"
                f"{p['peak_bytes'] / gb:>8.2f}G"
                f"  {'yes' if p['fits'] else 'NO'}")
    return "\n".join(lines)
