"""Multi-rank cases of ``tests/test_torch_mesh.py``: one process per rank
on gloo (CPU), started by :func:`run_ranks`.  Each rank runs the named
suite and rank 0 pickles its results for the test to check.

    python tests/torch_mesh_cases.py <suite> <rank> <world> <init file>
        <work dir>

A suite is a function of this module ``suite_<name>(mesh_of, work)`` that
returns a dict; ``mesh_of(spec)`` builds a mesh over the world's ranks
(several meshes share one process group).  No JAX is imported here.
"""
import datetime
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
for _p in (HERE, SRC):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TIMEOUT_S = 150          # a rank's collectives and the join, each


def run_ranks(suite: str, world: int, work: str, timeout: float = TIMEOUT_S,
              script: str = None) -> dict:
    """Start ``world`` rank processes of ``suite`` and return rank 0's
    results; a rank that fails or outlives ``timeout`` fails the call
    (every rank is killed first).  ``script``: the module file whose
    suites run (default this one; it calls this module's ``_main``)."""
    init = os.path.join(work, f"pg_init_{suite}")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [SRC, HERE, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(script or __file__), suite, str(r),
         str(world), init, work], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise AssertionError(f"ranks failed {bad}:\n"
                             + "\n".join(o[-3000:] for o in outs))
    with open(os.path.join(work, f"{suite}.pkl"), "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# helpers shared with the single-process tests
# ---------------------------------------------------------------------------

def host_leaves(tree):
    """Every tensor leaf of a port tree in JAX's order, as numpy."""
    from repro_torch import convert
    return [x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x) for x in convert.jax_leaves(tree)]


def full_state(mesh, params, opt_state, bank):
    """(params, opt_state, bank) with the FSDP shards gathered, on the
    host."""
    from repro_torch.parallel import sharding
    if mesh is not None:
        params = sharding.gather_tree(params, mesh)
        opt_state = sharding.gather_tree(opt_state, mesh)
    return host_leaves((params, opt_state, bank))


def toy_run(mesh, mode="replicated", sync="f32", steps=4, min_size=1 << 16,
            start_state=None, start=0):
    """The toy for ``steps`` steps under ``mesh``; (final full state on the
    host, per-step losses, the step, the live state, the steps'
    collective records)."""
    import torch_mesh_toy as toy
    from repro_torch.core import collectives
    step_fn, p, o, b, _ = toy.setup(mesh=mesh, grad_sync_mode=sync,
                                    param_sharding=mode,
                                    grad_sync_min_size=min_size)
    if start_state is not None:
        p, o, b = start_state
    losses = []
    with collectives.recording() as rec:
        for s in range(start, steps):
            p, o, b, m = step_fn(p, o, b, toy.make_batch(s), s)
            losses.append(float(m["loss"]))
    return full_state(mesh, p, o, b), losses, step_fn, (p, o, b), list(rec)


def summarize(records):
    """Collective records -> {(op, dtype): count} and the largest numel of
    each (op, dtype)."""
    counts, largest = {}, {}
    for r in records:
        k = f"{r['op']}/{r['dtype']}"
        counts[k] = counts.get(k, 0) + 1
        largest[k] = max(largest.get(k, 0), r["out_numel"])
    return counts, largest


def minicpm_setup(mesh, mode="replicated", sync="f32", min_size=1 << 16,
                  batch=8, seq=32, refresh_every=4):
    """Reduced minicpm_2b (4 layers, d 128, vocab 512) on the payload
    GEMMs with the bank; (step, params, opt_state, bank, data, loss_fn,
    policy)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core import statsbank
    from repro_torch.core.policy import make_policy
    from repro_torch.data import synthetic
    from repro_torch.launch import api
    from repro_torch.optim import optimizers, schedules
    from repro_torch.parallel import sharding
    from repro_torch.training.trainer import make_train_step
    cfg = get_reduced_config("minicpm_2b")
    pol = make_policy("s2fp8", "cuda", "payload")
    params = api.init_params(cfg, seed=0, device="cpu")
    loss_fn = api.make_loss_fn(cfg)
    chain = synthetic.markov_chain(0, cfg.vocab)

    def data(step):
        gen = torch.Generator().manual_seed(1000 + step)
        return synthetic.lm_batch(chain, gen, batch, seq, "cpu")
    opt = optimizers.adamw(weight_decay=0.01)
    scfg = statsbank.StatsConfig(refresh_every=refresh_every)
    bank = statsbank.init_bank(loss_fn, params, data(0), pol, scfg)
    step = make_train_step(loss_fn, opt, schedules.constant(3e-3), pol,
                           stats=scfg, mesh=mesh, grad_sync_mode=sync,
                           grad_sync_min_size=min_size,
                           param_sharding=mode)
    if mesh is not None:
        params = sharding.shard_tree(params, mesh, mode)
    opt_state = sharding.mark_opt_state(opt.init(params), params)
    return step, params, opt_state, bank, data, loss_fn, pol


def minicpm_run(mesh, steps=3, count_step=2, **kw):
    """Losses of ``steps`` steps, the collective records of each step, and
    the scalar-reduction count of step ``count_step`` (a steady step)."""
    from repro_torch.core import collectives, statsbank
    step, p, o, b, data, _, _ = minicpm_setup(mesh, **kw)
    losses, records, n_red = [], [], None
    for s in range(steps):
        with collectives.recording() as rec:
            if s == count_step:
                with statsbank.count_reductions() as cr:
                    p, o, b, m = step(p, o, b, data(s), s)
                n_red = cr.n
            else:
                p, o, b, m = step(p, o, b, data(s), s)
        losses.append(float(m["loss"]))
        records.append(list(rec))
    return losses, records, n_red, (p, o, b)


# ---------------------------------------------------------------------------
# suites
# ---------------------------------------------------------------------------

def suite_world4(mesh_of, work):
    """Every 4-rank case of tests/test_torch_mesh.py."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import collectives
    from repro_torch.optim import optimizers
    from repro_torch.parallel import sharding
    import torch_mesh_toy as toy
    out = {}
    m41 = mesh_of("4x1")

    # toy, f32 sync, every param mode: 4 ranks vs the tests' 1 rank
    for mode in ("replicated", "fsdp", "fsdp_q"):
        state, losses, _, _, rec = toy_run(m41, mode)
        out[f"toy_{mode}"] = (state, losses)
        out[f"toy_{mode}_collectives"] = rec

    # the psum-aware clip: integer-valued grads, each rank holding its dim-0
    # shard, against the full clip
    g = {"a": torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16) - 60,
         "b": torch.arange(8, dtype=torch.float32)[:, None].repeat(1, 4) - 3}
    i = m41.coords["data"]
    local = {k: v[2 * i:2 * i + 2].clone() for k, v in g.items()}
    with collectives.bind(m41):
        clipped, norm = optimizers.clip_by_global_norm(local, 1.0,
                                                       axis_name="data")
    out["clip"] = ({k: v.numpy() for k, v in clipped.items()}, float(norm),
                   i)
    out["clip_gathered"] = {k: collectives.all_gather(
        v, "data", mesh=m41).numpy() for k, v in clipped.items()}

    # checkpoints across 4 and 1 ranks, fsdp: restore the 1-rank
    # checkpoint taken after 2 steps, train to 4, save for the 1-rank side
    _, _, step_fn, (p, o, b), _ = toy_run(m41, "fsdp", steps=0)
    ck = CheckpointManager(os.path.join(work, "ckpt_from_1"), mesh=m41)
    (p, o, b), got = ck.restore((p, o, b))
    out["ckpt_restored_step"] = got
    out["ckpt_restored_state"] = full_state(m41, p, o, b)
    out["ckpt_shard_shapes"] = [tuple(x.shape) for x in
                                sharding._leaves(p)]
    for s in range(got, 4):
        p, o, b, m = step_fn(p, o, b, toy.make_batch(s), s)
    out["ckpt_continued_state"] = full_state(m41, p, o, b)
    CheckpointManager(os.path.join(work, "ckpt_from_4"), mesh=m41).save(
        4, (p, o, b))

    # pod x data x model: f32 bit for bit, s2fp8 (floor 64) finite
    m221 = mesh_of("2x2x1")
    out["pod_f32"] = toy_run(m221, "replicated")[:2]
    out["pod_fsdp"] = toy_run(m221, "fsdp")[:2]
    run = toy_run(m221, "replicated", "s2fp8", min_size=64)
    out["pod_s2fp8"] = run[:2]
    out["pod_s2fp8_collectives"] = run[4]

    # data x model: the model axis replicates
    m22 = mesh_of("2x2")
    out["dm_f32"] = toy_run(m22, "replicated")[:2]
    out["dm_coords"] = dict(m22.coords)

    # the replicated-batch fallback: an integer metric divided back
    out["int_metric"] = int_metric_case(m41)

    # compressed collectives (the inputs of tests/test_collectives.py)
    rng = np.random.RandomState(0)
    g_big = torch.from_numpy(
        (rng.standard_normal(1 << 17) * 1e-7).astype(np.float32))
    g_small = torch.from_numpy(
        (rng.standard_normal(100) * 1e-7).astype(np.float32))
    with collectives.recording() as rec:
        red = collectives.compressed_allreduce_1d(g_big, m41, "data")
        synced = collectives.compressed_grad_sync(
            {"big": g_big, "small": g_small}, m41, "data")
    out["compressed"] = (red.numpy(), synced["big"].numpy(),
                         synced["small"].numpy())
    out["compressed_collectives"] = list(rec)

    # reduced minicpm, s2fp8 sync and fsdp_q
    losses, records, n_red, (p, o, b) = minicpm_run(
        m41, mode="fsdp_q", sync="s2fp8", min_size=1 << 10)
    out["minicpm_fsdp_q"] = (losses, records, n_red,
                             [tuple(x.shape) for x in sharding._leaves(p)],
                             sharding.shard_flags(p))
    losses, records, n_red, _ = minicpm_run(
        m41, mode="replicated", sync="s2fp8", min_size=1 << 10)
    out["minicpm_replicated_s2fp8"] = (losses, records, n_red)
    return out


def int_metric_case(mesh):
    """An fp32 toy step whose loss reports its rows as an int64 metric:
    (metric with the batch split, metric on the replicated fallback)."""
    from repro_torch.core.policy import make_policy
    from repro_torch.optim import optimizers, schedules
    from repro_torch.training.trainer import make_train_step
    import torch_mesh_toy as toy

    def loss(params, batch, pol):
        y = pol.dot(batch["x"], params["w"])
        rows = torch.tensor(batch["x"].shape[0], dtype=torch.int64)
        return torch.mean(torch.sum(y * batch["t"], dim=-1)), {"rows": rows}
    opt = optimizers.adamw()
    step = make_train_step(loss, opt, schedules.constant(1e-3),
                           make_policy("fp32"), mesh=mesh)
    res = []
    for rows in (8, 6):                  # 8 splits 4 ways, 6 does not
        params = toy.make_params()
        b = {k: v[:rows] for k, v in toy.make_batch(0).items()}
        _, _, m = step(params, opt.init(params), b, 0)
        res.append(int(m["rows"]))
    return res


def _main(suites=None):
    """Run one rank of a suite of ``suites`` (a module's globals; default
    this module's)."""
    suite, rank, world, init, work = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch import mesh as lmesh
    dist.init_process_group(
        "gloo", init_method=f"file://{init}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = (suites or globals())[f"suite_{suite}"](
            lmesh.make_mesh_from_spec, work)
        if rank == 0:
            with open(os.path.join(work, f"{suite}.pkl"), "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main()
