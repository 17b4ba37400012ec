"""Multi-pod dry run on fake tensors: trace one step of every (arch x shape
x mesh) cell and write its cost and roofline (port of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm_2b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mem-report

The reference lowers and compiles each cell for 256 or 512 TPU devices and
reads XLA's cost and memory analyses.  The port has no compiler to ask, so
``run_cell`` traces the step itself, as rank 0 of a production mesh with
no process group (``launch.mesh.DryMesh``: 16 x 16 or 2 x 16 x 16), on
fake tensors (``launch.api`` structs: ``FakeTensorMode``, nothing is
allocated, on any device) under ``roofline.trace_cost``: FLOPs, bytes,
collective bytes (each collective records itself and moves nothing),
peak live bytes and the kernels the step calls.  It runs the policy's
engine (``cuda`` by default) on fake CPU tensors, where each kernel
wrapper takes its plain version and the counter charges the call as the
kernel; a fake tensor never reaches a kernel.

  * train: ``api.make_train_step`` (AdamW, the config's schedule) on the
    mesh under ``TRAIN_RULES``: the rank slices its rows of the global
    batch (the all-or-nothing divisibility guard of
    ``parallel.sharding``), computes its part of the ``model`` axis, and
    the f32 gradient sync is recorded.  Exact-stats s2fp8 with no bank and
    no guard, as the reference traces.
  * prefill / decode: ``api.make_prefill_step`` / ``make_decode_step`` on
    the mesh under ``DECODE_RULES``, on the rank's part of the batch and
    caches (``api.batch_pspecs`` / ``cache_pspecs``: the batch axes'
    entries and the caches' ``S`` entry over ``model``), under no_grad.

Params are placed as the reference's are, by ``api.param_pspecs``
(``--shard-params pspecs``, the default: ``T`` entries over ``model``,
``F`` over ``data``; ``parallel.sharding.place_params``), and each use
gathers what the compute keeps whole.  ``--shard-params replicated``
keeps every leaf whole and the ``model`` axis replicated (the launcher's
mesh step); ``fsdp`` / ``fsdp_q`` hand the train step the rank's dim-0
shards (``sharding.shard_tree``; fsdp_q also a StatsBank built from the
full params, which it needs) with the ``model`` axis replicated.

Records are cached incrementally in ``build/dryrun_torch.json`` (the
``build/`` directory is not committed), under the reference's keys:
``status``, ``compile_s`` (the trace's seconds), ``memory_analysis``,
``roofline``, ``policy``; plus ``model_axis`` (the logical axes that
split over ``model`` and their sizes, e.g. ``{"mlp": 16, "vocab": 16}``,
or ``"replicated"``), ``param_sharding`` and ``param_placement``,
``coll_by_axis`` (collective bytes a rank moves over each mesh axis),
``kernel_calls`` and ``cost`` (the whole ``TraceCost``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import ARCH_IDS, SHAPE_SPECS, SHAPES, get_config
from repro_torch.core.policy import make_policy
from repro_torch.launch import api, memplan
from repro_torch.launch.mesh import axis_sizes, make_production_mesh
from repro_torch.parallel import sharding as shd
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline.trace_cost import trace_cost

RESULTS = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch.json"

LM_ARCHS = [a for a in ARCH_IDS if a not in
            ("resnet20_cifar", "ncf_ml1m", "transformer_tiny")]
PARAM_SHARDING = ("pspecs", "replicated", "fsdp", "fsdp_q")
PLACEMENT = {"pspecs": "param_pspecs: T over model, F over data",
             "replicated": "replicated",
             "fsdp": "dim 0 over data", "fsdp_q": "dim 0 over data"}


def _load_results(path=RESULTS) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _save_results(res: dict, path=RESULTS) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(res, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _local_rows(tree, specs, sizes, axes=("pod", "data", "model")):
    """Rank 0's part of each leaf: every dim whose spec entry names mesh
    axes of ``axes`` cut to its first 1 / prod(sizes) entries (a copy, so
    the leaf holds only its own bytes): the batch rows over pod / data, a
    cache's positions (``S``) over model."""
    def one(leaf, spec):
        for dim, entry in enumerate(spec):
            names = (entry,) if isinstance(entry, str) else (entry or ())
            n = 1
            for a in names:
                if a in axes:
                    n *= sizes[a]
            if n > 1:
                leaf = leaf.narrow(dim, 0, leaf.shape[dim] // n).clone()
        return leaf

    if isinstance(tree, dict):
        return {k: _local_rows(v, specs[k], sizes) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_local_rows(v, s, sizes)
                          for v, s in zip(tree, specs))
    return None if tree is None else one(tree, specs)


def _storages(tree) -> dict:
    from torch.utils._pytree import tree_flatten
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)}


def run_cell(arch: str, shape: str, multi_pod: bool,
             policy_mode: str = "s2fp8", overrides: dict | None = None,
             truncate_output: bool | None = None, tag: str = "",
             moe_routing: str | None = None,
             output_dtype: str | None = None,
             param_sharding: str = "pspecs") -> dict:
    """Trace one cell on fake tensors; the record (module docstring)."""
    overrides = dict(overrides) if overrides else {}
    shard_kv_seq = overrides.pop("_shard_kv_seq", True)
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    if moe_routing and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  routing=moe_routing))
    reason = cfg.skip_reason(shape)
    if reason:
        return {"status": "skipped", "reason": reason}
    seq, gbs, kind = SHAPE_SPECS[shape]
    if kind != "train" and param_sharding in ("fsdp", "fsdp_q"):
        raise ValueError("--shard-params fsdp / fsdp_q apply to train cells "
                         "only")

    mesh = make_production_mesh(multi_pod=multi_pod, dry=True)
    sizes = axis_sizes(mesh)
    pol = make_policy(policy_mode)
    if truncate_output is not None:
        pol = dataclasses.replace(pol, truncate_output=truncate_output)
    if output_dtype:
        pol = dataclasses.replace(pol, output_dtype=output_dtype)
    rules = shd.TRAIN_RULES if kind == "train" else shd.DECODE_RULES
    if not shard_kv_seq:
        rules = dict(rules)
        rules["kv_seq"] = None

    # serving runs bf16 weights; training keeps f32 masters (Fig. 4)
    pstruct = api.param_struct(
        cfg, dtype=torch.float32 if kind == "train" else torch.bfloat16)
    bstruct = api.batch_struct(cfg, shape)
    bspecs = api.batch_pspecs(bstruct, sizes)
    fake = api.fake_mode()

    # the model axis splits under the rules with params placed by
    # param_pspecs; the other modes keep it replicated (no rules)
    split = param_sharding == "pspecs"
    ctx = (shd.use_rules(rules, sizes) if split
           else contextlib.nullcontext())
    t0 = time.perf_counter()
    with fake, ctx:
        where = params = None
        if split:
            where = api.placement(cfg, mesh, pstruct)
            params = shd.place_params(pstruct, mesh, specs=where.specs)
        if kind == "train":
            from repro_torch.core import statsbank
            stats = bank = None
            if param_sharding == "fsdp_q":
                stats = statsbank.StatsConfig()
                # the bank is built from the full params, on the rank's rows
                bank = statsbank.init_bank(
                    api.make_loss_fn(cfg), pstruct,
                    _local_rows(bstruct, bspecs, sizes), pol, stats)
            # pspecs is a placement, not one of the trainer's modes
            step_fn, opt = api.make_train_step(
                cfg, pol, stats=stats, mesh=mesh, placement=where,
                param_sharding="replicated" if split else param_sharding)
            if not split:
                params = shd.shard_tree(pstruct, mesh, param_sharding)
            ostate = shd.mark_opt_state(opt.init(params), params)
            args = (params, ostate, bstruct) + (
                (bank,) if stats is not None else ())
            with trace_cost(args) as cost:
                if stats is None:
                    out = step_fn(params, ostate, bstruct, 0)
                else:
                    out = step_fn(params, ostate, bank, bstruct, 0)
        else:
            batch = _local_rows(bstruct, bspecs, sizes)
            on = dict(placement=where)
            params = params if split else pstruct
            with torch.no_grad():
                if kind == "prefill" and cfg.enc_dec:
                    args = (params, batch)
                    with trace_cost(args) as cost:
                        out = api.make_prefill_step(cfg, pol, **on)(*args)
                else:
                    cstruct = api.cache_struct(cfg, shape)
                    cspecs = api.cache_pspecs(cfg, cstruct, sizes,
                                              shard_kv_seq=shard_kv_seq)
                    caches = _local_rows(
                        cstruct, cspecs, sizes,
                        ("pod", "data", "model") if split
                        else ("pod", "data"))
                    args = (params, batch, caches)
                    if kind == "prefill":
                        with trace_cost(args) as cost:
                            out = api.make_prefill_step(cfg, pol,
                                                        **on)(*args)
                    else:
                        with trace_cost(args) as cost:
                            out = api.make_decode_step(cfg, pol,
                                                       **on)(*args, 0)
        model_axis = (model_axis_record(cfg, mesh, rules, shape)
                      if split else "replicated")
    trace_s = time.perf_counter() - t0
    held = _storages(args)
    output_bytes = sum(v for k, v in _storages(out).items() if k not in held)
    mem = {"argument_bytes": cost.argument_bytes,
           "output_bytes": output_bytes, "temp_bytes": cost.temp_bytes,
           "peak_bytes": cost.peak_bytes, "generated_code_bytes": 0}
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rl = roofline.analyze(arch, shape, mesh_name, mesh.size, cost,
                          mem_bytes=float(cost.peak_bytes),
                          model_gflops_total=roofline.model_flops(
                              cfg, shape) / 1e9)
    return {"status": "ok", "compile_s": trace_s, "memory_analysis": mem,
            "roofline": rl.to_dict(), "policy": policy_mode,
            "model_axis": model_axis, "param_sharding": param_sharding,
            "param_placement": PLACEMENT[param_sharding],
            "coll_by_axis": dict(cost.coll_axis),
            "kernel_calls": dict(cost.calls), "cost": cost.to_dict(),
            "tag": tag}


def model_axis_record(cfg, mesh, rules, shape: str):
    """The logical axes that split over the model axis in a cell, with
    their sizes (``"replicated"`` where none does): the vocab, and the
    query / K/V heads and MLP of the ``TP_BLOCK_TYPES`` blocks, under
    ``rules`` on ``mesh``; the caches' positions (``kv_seq``) in prefill
    and decode cells."""
    from repro_torch.core import collectives
    from repro_torch.models import blocks
    from repro_torch.models import transformer as tlm
    seq, _, kind = SHAPE_SPECS[shape]
    out = {}
    with shd.use_rules(rules, dict(mesh.shape)), collectives.bind(mesh):
        if cfg.enc_dec:
            return "replicated"
        vs = tlm.vocab_split(cfg)
        if vs is not None:
            out["vocab"] = vs.size
        for btype, _ in tlm.segments_of(cfg):
            sp = blocks.attn_split(cfg, btype)
            if sp is not None:
                out["heads"] = sp.heads.size
                if sp.kv is not None:
                    out["kv"] = sp.kv.size
            ms = blocks.mlp_split(cfg, btype, blocks.block_d_ff(cfg, btype))
            if ms is not None:
                out["mlp"] = ms.size
            if kind != "train" and btype in blocks.TP_BLOCK_TYPES:
                ks = shd.split("kv_seq", seq)
                if ks is not None:
                    out["kv_seq"] = ks.size
    return out or "replicated"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--policy", default="s2fp8")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="not available: the port compiles no HLO (a dry "
                         "cell is a trace on fake tensors); passing it is "
                         "an error")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--attn-impl", default=None, choices=[None, "naive",
                                                          "flash"])
    ap.add_argument("--ssm-impl", default=None,
                    choices=[None, "step", "unroll8", "ssd"])
    ap.add_argument("--decode-kv-seq", default=None, choices=[None, "0", "1"],
                    help="0: replicate KV-cache seq axis (batch-only decode "
                         "sharding variant)")
    ap.add_argument("--moe-routing", default=None,
                    choices=[None, "global", "grouped"])
    ap.add_argument("--output-dtype", default=None,
                    choices=[None, "bfloat16"])
    ap.add_argument("--truncate-output", default=None,
                    choices=[None, "0", "1"])
    ap.add_argument("--shard-params", default="pspecs",
                    choices=PARAM_SHARDING,
                    help="the rank holds its part of each leaf as "
                         "api.param_pspecs places it ('pspecs', the "
                         "default, the model axis split under the rules), "
                         "full params with the model axis replicated "
                         "('replicated'), or, train cells only, its dim-0 "
                         "shards over 'data' ('fsdp', 'fsdp_q': payload "
                         "gathers, needs a StatsBank, which the cell "
                         "builds)")
    ap.add_argument("--results", default=str(RESULTS),
                    help="the JSON file of cached records (default: "
                         "build/dryrun_torch.json)")
    ap.add_argument("--tag", default="", help="suffix for the results key "
                    "(perf-iteration label, e.g. 'flash')")
    ap.add_argument("--mem-report", action="store_true",
                    help="print the per-device param/optimizer residency "
                         "plan (launch/memplan.py) for the selected archs "
                         "under replicated/fsdp/fsdp_q and exit — no "
                         "trace; the fits verdict uses the trainer's own "
                         "per-leaf eligibility rules")
    return ap


def cell_key(arch, shape, mesh_name, policy, shard_params="pspecs",
             tag="") -> str:
    key = f"{arch}|{shape}|{mesh_name}|{policy}"
    if shard_params != "pspecs":
        key += f"|{shard_params}"
    return key + (f"|{tag}" if tag else "")


def _reusable(rec, shard_params: str) -> bool:
    """A cached record serves again: a skip, or a trace of the same
    param placement (an un-suffixed record of an older file may hold
    another placement under the same key)."""
    if rec is None:
        return False
    return rec.get("status") == "skipped" or (
        rec.get("status") == "ok"
        and rec.get("param_sharding") == shard_params)


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo has no counterpart in the port: there is no "
                 "compiled HLO, the cell is a trace on fake tensors")
    if args.mem_report:
        archs = LM_ARCHS if (args.all or args.arch is None) else [args.arch]
        sizes = ({"pod": 2, "data": 16, "model": 16}
                 if args.mesh == "multi" else {"data": 16, "model": 16})
        print(memplan.format_report(archs, sizes))
        return 0
    overrides = {}
    if args.attn_impl:
        overrides["attn_impl"] = args.attn_impl
    if args.ssm_impl:
        overrides["ssm_impl"] = args.ssm_impl
    if args.decode_kv_seq is not None:
        overrides["_shard_kv_seq"] = args.decode_kv_seq == "1"

    archs = LM_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    trunc_out = (None if args.truncate_output is None
                 else args.truncate_output == "1")
    results = _load_results(args.results)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                key = cell_key(arch, shape, mesh_name, args.policy,
                               args.shard_params, args.tag)
                if _reusable(results.get(key), args.shard_params) \
                        and not args.force:
                    print(f"[cached] {key}: {results[key]['status']}")
                    continue
                print(f"[run] {key} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, mp, args.policy,
                                   overrides=overrides or None,
                                   truncate_output=trunc_out, tag=args.tag,
                                   moe_routing=args.moe_routing,
                                   output_dtype=args.output_dtype,
                                   param_sharding=args.shard_params)
                except Exception as e:
                    rec = {"status": "fail",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    failures += 1
                results[key] = rec
                _save_results(results, args.results)
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(f"  ok trace={rec['compile_s']:.1f}s "
                          f"flops/dev={r['hlo_gflops_per_dev']:.1f}G "
                          f"coll/dev={r['coll_gbytes_per_dev']:.3f}GB "
                          f"peak/dev={rec['memory_analysis']['peak_bytes'] / 1e9:.2f}GB "
                          f"dominant={r['dominant']} mfu={r['mfu']:.3f}",
                          flush=True)
                elif rec["status"] == "skipped":
                    print(f"  skipped: {rec['reason']}")
                else:
                    print(f"  FAIL: {rec['error']}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
