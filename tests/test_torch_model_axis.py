"""The port's model axis: tensor-, vocab- and sequence-parallel dense
decoder LMs under the reference's rule tables, with params placed by
``param_pspecs`` (``parallel.sharding``, ``core/collectives.py``'s
model-axis primitives, the split stats of ``core/backend.py`` and
``core/statsbank.py``, the split contractions of ``core/qdot.py`` /
``core/policy.py``, ``models/blocks.py`` and ``models/transformer.py``).

Reduced minicpm_2b (4 layers, 4 heads and 4 K/V heads, d_ff 256, vocab
512) and reduced gemma3_1b (1 K/V head: each rank's query heads attend
with the whole K/V head; ``local`` blocks with a window of 64) start from
the reference's ``init_params`` (numpy, ``convert.params_from_jax``).

Multi-rank cases run on gloo in two spawned worlds
(``tests/torch_model_axis_cases.py``): 2 ranks (a 1 x 2 mesh) and 4
ranks (2 x 2 and 1 x 4), beside the meshless runs in this process and
the reference's steps compiled by GSPMD on a (1, 4) host mesh and run in
JAX subprocesses (``tests/torch_model_axis_ref.py``).  The port's 1 x 4
runs are held against both: the meshless port and the reference's own
split of the same params and inputs.

Tolerances, each stated at its assert:

* f32 (f32 activations too, so that only the order of f32 sums differs:
  the row-parallel partial sums, the vocab-parallel cross entropy): 3 SGD
  steps' losses and the gathered params within 1e-6 relative (measured
  against the meshless port at most 8e-8 and 5e-7; against the
  reference's GSPMD step 2.3e-7 and 5.2e-7).  SGD: AdamW's first steps
  follow the gradients' signs, which another summation order flips where
  a gradient is near 0.
* s2fp8 (exact stats on the ``cuda_fused`` engine's payload GEMMs, bf16
  activations; the reference's ``ref`` engine's payload GEMMs): losses
  within the quickstart's s2fp8 budget 0.019 (measured at most 0.0031
  against the meshless port, 0.0036 against the reference); the params'
  updates by cosine and norm (a sum in another order moves a code, and
  e5m2's two mantissa bits make every whole-model gradient of two sound
  runs differ by ~10% a leaf; measured against the reference cos 0.989
  and 0.991, norms within 0.1%).
* decode under ``DECODE_RULES``: f32 logits within 1e-5 of their max
  (measured against the reference at most 1.6e-6); s2fp8 within the
  serving budget of ``test_torch_encdec.py`` (mean |diff| at most 0.1 x
  mean |x|, max at most 0.1 x max |x|; measured against the reference
  0.074 and 0.088, against the meshless port 0.053 and 0.062).
"""
import concurrent.futures
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import torch_mesh_cases
import torch_model_axis_cases as cases
from repro.configs import get_config as jget_config
from repro.configs import get_reduced_config as jreduced
from repro.launch import api as japi
from repro_torch.configs import get_config
from repro_torch.configs.base import ARCH_IDS
from repro_torch.core import collectives
from repro_torch.core.policy import make_policy
from repro_torch.launch import api
from repro_torch.launch import mesh as lmesh
from repro_torch.launch.mesh import DryMesh
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.parallel import sharding as shd
from repro_torch.roofline.trace_cost import trace_cost

jax.config.update("jax_platform_name", "cpu")

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLDS = ("1x2", "2x2", "1x4")
MODES = ("f32", "s2fp8")

# the reference's side (tests/torch_model_axis_ref.py): its GSPMD steps on
# a (1, 4) host mesh, split over two processes of about equal length (50-60
# s each alone, nearly all of it XLA's compiles); a loaded host can take
# several times that
REF_JOBS = (("gemma3_1b:s2fp8:train", "gemma3_1b:f32:train",
             "gemma3_1b:f32:serve"),
            ("gemma3_1b:s2fp8:serve", "minicpm_2b:f32:train",
             "minicpm_2b:f32:serve", "minicpm_2b:s2fp8:train",
             "minicpm_2b:s2fp8:serve", "flops"))
REF_TIMEOUT_S = 600
REF_SCRIPT = os.path.join(os.path.dirname(__file__),
                          "torch_model_axis_ref.py")


@pytest.fixture(scope="module")
def mesh1():
    """A 1-rank gloo group and a 1 x 1 mesh over it (kept: another test
    module in this worker may reuse the group)."""
    lmesh.init_distributed("cpu")
    return lmesh.make_mesh_from_spec("1x1")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's params (numpy) and the port's inputs in the work
    dir; the 2- and 4-rank suites and the reference's GSPMD runs, all in
    parallel with the meshless runs here.  Returns (results by key, with
    the reference's under "ref"; meshless runs; work dir)."""
    work = str(tmp_path_factory.mktemp("model_axis"))
    for arch in cases.ARCHS:
        params = jax.device_get(jax.jit(lambda k: japi.init_params(
            jreduced(arch), k))(jax.random.PRNGKey(0)))
        with open(os.path.join(work, f"params_{arch}.pkl"), "wb") as f:
            pickle.dump(params, f)
        cases.save_inputs(arch, work)
    refs = [os.path.join(work, f"ref_{i}.pkl") for i in range(len(REF_JOBS))]
    jprocs = [subprocess.Popen([sys.executable, REF_SCRIPT, work, ref, *jobs],
                               env=dict(os.environ, PYTHONPATH=_SRC),
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for ref, jobs in zip(refs, REF_JOBS)]
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = [pool.submit(torch_mesh_cases.run_ranks, name, n, work,
                                script=cases.__file__)
                    for name, n in (("world2", 2), ("world4", 4))]
            meshless = {}
            for arch in cases.ARCHS:
                for mode in MODES:
                    meshless[("train", arch, mode)] = cases.train(
                        arch, mode, None, work)
                    meshless[("serve", arch, mode)] = cases.serve(
                        arch, mode, None, work)
                for mode in cases.CHAIN_MODES:
                    meshless[("train", arch, mode)] = cases.train(
                        arch, mode, None, work)
            out = {}
            for r in runs:
                out.update(r.result())
        logs = [p.communicate(timeout=REF_TIMEOUT_S)[0] for p in jprocs]
    finally:
        for p in jprocs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(jprocs, logs):
        assert p.returncode == 0, log[-3000:]
    out["ref"] = {}
    for ref in refs:
        with open(ref, "rb") as f:
            out["ref"].update(pickle.load(f))
    return out, meshless, work


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _hold_train(got, want, mode, arch, work):
    """3 steps' losses and final params against another run's (the
    tolerances of the module docstring)."""
    losses, params = got
    want_l, want_p = want
    assert all(np.isfinite(losses))
    if mode == "f32":
        loss_gap = max(abs(g - w) / abs(w) for g, w in zip(losses, want_l))
        rel = max(_rel(g, w) for g, w in zip(params, want_p))
        assert loss_gap <= 1e-6, (losses, want_l)
        assert rel <= 1e-6, rel
        return
    gap = max(abs(g - w) for g, w in zip(losses, want_l))
    assert gap <= 0.019, (losses, want_l)
    init = cases.host(cases.full_params(arch, work))
    upd = np.concatenate([(g - i).ravel() for g, i in zip(params, init)])
    ref = np.concatenate([(w - i).ravel() for w, i in zip(want_p, init)])
    # the updates' directions and sizes (measured cos 0.981-0.993, norm
    # ratio within 0.07%; test_torch_encdec.py holds whole-model s2fp8
    # gradients of the two packages by cos >= 0.98 on one step)
    cos = upd @ ref / (np.linalg.norm(upd) * np.linalg.norm(ref))
    ratio = np.linalg.norm(upd) / np.linalg.norm(ref)
    assert cos >= 0.95, cos
    assert 0.95 <= ratio <= 1.05, ratio


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", cases.ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_train_matches_meshless(worlds, world, arch, mode):
    """3 steps under ``TRAIN_RULES`` with params placed by
    ``param_pspecs``: losses and the gathered params against the meshless
    port from the same params and batches (tolerances in the module
    docstring)."""
    out, meshless, work = worlds
    _hold_train(out[f"train_{world}_{arch}_{mode}"],
                meshless[("train", arch, mode)], mode, arch, work)


@pytest.mark.parametrize("arch", cases.ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_train_matches_the_reference_gspmd(worlds, arch, mode):
    """The port on a 1 x 4 gloo world against the reference's own split:
    its train step compiled by GSPMD on a (1, 4) host mesh under
    ``TRAIN_RULES``, params and optimizer state placed by its
    ``param_pspecs``, from the same params and batches, 3 steps.  Losses
    and the gathered params within the tolerances of the module
    docstring."""
    out, _, work = worlds
    _hold_train(out[f"train_1x4_{arch}_{mode}"],
                out["ref"][("train", arch, mode)], mode, arch, work)


# the quickstart's 60-step loss budgets (ROADMAP, "Parity is a budget"):
# s2fp8's for fig4, fp32's for bf16, fp8's (measured at 1 x 2, 3 steps:
# fig4 0.0018, bf16 0.00019, fp8 0.0)
CHAIN_BUDGET = {"fig4": 0.019, "bf16": 0.0084, "fp8": 0.061}


@pytest.mark.parametrize("arch", cases.ARCHS)
@pytest.mark.parametrize("mode", cases.CHAIN_MODES)
def test_chain_modes_train_under_the_split(worlds, arch, mode):
    """The policy's chain under the split at 1 x 2 (``Policy._dense_tp``:
    split operands truncated with the whole tensor's stats, whole ones
    through ``copy_in`` after theirs, partial outputs all-reduced before
    the output truncation): s2fp8 fig4 on the ``plain`` engine, bf16 and
    raw fp8, 3 steps' losses within the quickstart's budgets of the
    meshless port's."""
    out, meshless, _ = worlds
    losses, params = out[f"train_1x2_{arch}_{mode}"]
    want = meshless[("train", arch, mode)][0]
    assert all(np.isfinite(losses)) and all(np.isfinite(p).all()
                                            for p in params)
    gap = max(abs(g - w) for g, w in zip(losses, want))
    assert gap <= CHAIN_BUDGET[mode], (losses, want)


@pytest.mark.parametrize("arch", cases.ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_mesh_1x1_equals_meshless_bitwise(mesh1, worlds, arch, mode):
    """At ``model`` 1 the step adds no arithmetic: under ``TRAIN_RULES``
    on a 1 x 1 mesh (a 1-rank gloo group) with params placed by
    ``param_pspecs``, the losses and params equal the meshless run's bit
    for bit."""
    _, meshless, work = worlds
    losses, params = cases.train(arch, mode, mesh1, work)
    want_l, want_p = meshless[("train", arch, mode)]
    assert losses == want_l
    assert all(np.array_equal(g, w) for g, w in zip(params, want_p))


def _hold_logits(got_steps, want_steps, mode):
    """Every step's logits within the budgets of the module docstring."""
    assert len(got_steps) == len(want_steps) == 5
    for got, want in zip(got_steps, want_steps):
        got = np.asarray(got, np.float32)
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape and np.isfinite(got).all()
        d = np.abs(got - want)
        if mode == "f32":
            assert d.max() <= 1e-5 * np.abs(want).max(), d.max()
        else:
            assert d.mean() <= 0.1 * np.abs(want).mean(), d.mean()
            assert d.max() <= 0.1 * np.abs(want).max(), d.max()


@pytest.mark.parametrize("arch", cases.ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_decode_with_split_kv_seq_matches_meshless(worlds, arch, mode):
    """Prefill then 4 decode steps under ``DECODE_RULES`` at 1 x 2: the
    caches' positions split over ``model`` (each rank holds 32 of 64;
    gemma3's local blocks are 64-position rings), the MLP and vocab split,
    heads whole.  Logits within the budgets of the module docstring."""
    out, meshless, _ = worlds
    _hold_logits(out[f"serve_1x2_{arch}_{mode}"],
                 meshless[("serve", arch, mode)], mode)


@pytest.mark.parametrize("arch", cases.ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_decode_matches_the_reference_gspmd(worlds, arch, mode):
    """Prefill then 4 decode steps under ``DECODE_RULES`` on a 1 x 4 gloo
    world (each rank 16 of the caches' 64 positions) against the
    reference's prefill and decode steps compiled by GSPMD on a (1, 4)
    host mesh, caches placed by its ``cache_pspecs``, same params and
    tokens; the 1 x 4 run against the meshless port beside it.  Logits
    within the budgets of the module docstring."""
    out, meshless, _ = worlds
    got = out[f"serve_1x4_{arch}_{mode}"]
    _hold_logits(got, out["ref"][("serve", arch, mode)], mode)
    _hold_logits(got, meshless[("serve", arch, mode)], mode)


@pytest.mark.parametrize("engine", ["plain", "cuda", "cuda_fused",
                                    "refresh"])
@pytest.mark.parametrize("world", ["1x2", "1x4"])
def test_split_stats_agree_across_ranks(worlds, engine, world):
    """A tensor split by columns over ``model``: every rank's whole-tensor
    (alpha, beta) equal bit for bit (the partials gathered in f64 and
    summed in axis order), and within 4 ulps of the meshless exact stats
    (per engine, and through a bank refresh).  The meshless sum of
    log2|x| runs in f32 over the whole tensor, the split one in f32 per
    rank and f64 across them: measured 0 ulps on alpha, 3 on beta (=
    -alpha x mean); the stats kernels' own bound against the plain sums
    is 4 ulps (``tests/test_torch_stats_schedule.py``)."""
    out, _, _ = worlds
    ranks, whole = out[f"stats_{world}"][engine]
    assert ranks.shape == (int(world[-1]), 2)
    assert (ranks == ranks[0]).all(), ranks
    ulp = np.spacing(np.abs(whole).astype(np.float32))
    assert (np.abs(ranks[0] - whole) <= 4 * ulp).all(), (ranks[0], whole)


def test_row_parallel_truncates_after_the_all_reduce(worlds):
    """A row-parallel payload dot truncates the sum of the ranks' f32
    partials (Eq. 5 on a partial sum is another function): its output
    matches the whole dot's but for ulps (the sum's other order shifts
    the output stats, and so the grid, by ulps; a code that moves moves
    by a grid step, 1/4 of its value at most; measured 0 of 1,536 outputs
    moved by more than 1e-3 of their size), while truncating each partial
    in its GEMM's epilogue and summing after moves most of them (measured
    97%)."""
    y, whole, fused = worlds[0]["row_parallel_1x2"]

    def moved(a):
        return (np.abs(a - whole) > 1e-3 * np.abs(whole)).mean()
    assert moved(y) <= 0.01, moved(y)
    assert moved(fused) >= 0.5, moved(fused)


def test_rank0_flops_match_the_reference_gspmd(worlds):
    """Reduced minicpm_2b's train step: the port's rank 0 on
    ``DryMesh((1, 4))`` under ``TRAIN_RULES`` (``trace_cost`` on fake
    tensors) against the reference's per-device FLOPs of its GSPMD step
    on a (1, 4) host mesh (``hlo_cost``), within 10% (the reference's flash
    ``ref`` node also counts the masked half of each score square:
    measured 0.953)."""
    out = worlds[0]
    from repro_torch.configs import get_reduced_config
    cfg = get_reduced_config("minicpm_2b").replace(remat=False)
    mesh = DryMesh((1, 4), ("data", "model"))
    pol = make_policy("s2fp8", "cuda", "payload")
    full = api.param_struct(cfg)
    with api.fake_mode():
        where = api.placement(cfg, mesh, full)
        params = shd.place_params(full, mesh, specs=where.specs)
        step, opt = api.make_train_step(cfg, pol, mesh=mesh,
                                        placement=where)
        ostate = opt.init(params)
        toks = torch.zeros((2, 64), dtype=torch.int64)
        batch = {"tokens": toks, "labels": toks}
        with shd.use_rules(shd.TRAIN_RULES, dict(mesh.shape)), \
                trace_cost((params, ostate, batch)) as cost:
            step(params, ostate, batch, 0)
    ratio = cost.flops / out["ref"]["flops"]
    assert 0.9 <= ratio <= 1.1, (cost.flops, out["ref"]["flops"])
    assert cost.coll_axis["model"] > 0


@pytest.mark.parametrize("world", ["2x2", "1x4"])
@pytest.mark.parametrize("arch", cases.ARCHS)
def test_place_params_round_trips(worlds, world, arch):
    """``place_params`` then its inverse ``unplace_params`` gives the full
    tree back bit for bit."""
    back, full = worlds[0][f"roundtrip_{world}_{arch}"]
    assert all(np.array_equal(b, f) for b, f in zip(back, full))


@pytest.mark.parametrize("sizes", [{"data": 16, "model": 16},
                                   {"pod": 2, "data": 16, "model": 16}])
def test_placement_follows_the_reference_pspecs(sizes):
    """For every full-width config the port's ``param_pspecs`` equal the
    reference's, and ``place_params`` on a ``DryMesh`` of those sizes
    leaves rank 0 each leaf's shape divided by its spec's axes."""
    mesh = DryMesh(tuple(sizes.values()), tuple(sizes))
    for arch in [a for a in ARCH_IDS if a not in ("resnet20_cifar",
                                                  "ncf_ml1m")]:
        cfg = get_config(arch)
        struct = api.param_struct(cfg)
        jcfg = jget_config(arch)
        jspecs = jax.tree_util.tree_leaves(
            japi.param_pspecs(jcfg, japi.param_struct(jcfg), sizes),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        specs = shd._spec_leaves(api.param_pspecs(cfg, struct, sizes))
        assert [tuple(s) for s in specs] == [tuple(s) for s in jspecs], arch
        with api.fake_mode():
            local = shd.place_params(struct, mesh, sizes)
        for leaf, got, spec in zip(tree_leaves(struct), tree_leaves(local),
                                   specs):
            want = list(leaf.shape)
            for dim, entry in enumerate(spec):
                for a in ((entry,) if isinstance(entry, str)
                          else (entry or ())):
                    want[dim] //= sizes[a]
            assert list(got.shape) == want, (arch, spec)


def test_shard_and_split_follow_the_rules():
    """``split`` under the rules on a bound mesh: the model axis's size
    and this rank's coordinate, None where the rules replicate the axis,
    where it does not divide, without rules or without a bound mesh;
    ``shard`` cuts those dims (rank 0 of a dry mesh: the first slice)."""
    mesh = DryMesh((2, 4), ("data", "model"))
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    with shd.use_rules(shd.TRAIN_RULES, dict(mesh.shape)):
        assert shd.split("mlp", 12) is None            # no mesh bound
        with collectives.bind(mesh):
            assert shd.split("mlp", 12) == shd.Split("model", 4, 0)
            assert shd.split("mlp", 10) is None        # the guard
            assert shd.split("kv_seq", 12) is None     # replicated
            assert shd.split("batch", 8) is None       # the step's axes
            assert torch.equal(shd.shard(x, "batch", "mlp"), x[:, :3])
    with shd.use_rules(shd.DECODE_RULES, dict(mesh.shape)), \
            collectives.bind(mesh):
        assert shd.split("heads", 12) is None
        assert shd.split("kv_seq", 12).size == 4
    assert shd.split("mlp", 12) is None                # no rules


def test_dry_mesh_collectives_give_defined_values_on_real_tensors():
    """On a ``DryMesh`` (rank 0, no process group) a real tensor's gather
    tiles its own chunk and a reduce-scatter keeps its own slice: nothing
    moves, and a real run on one card computes on finite numbers."""
    mesh = DryMesh((1, 4), ("data", "model"))
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    with collectives.recording() as rec:
        g = collectives.gather_dim(x, "model", 1, mesh=mesh)
        r = collectives.reduce_scatter(torch.arange(8.0), "model",
                                       mesh=mesh)
    assert torch.equal(g, torch.cat([x] * 4, dim=1))
    assert torch.equal(r, torch.arange(2.0))
    assert [e["axis"] for e in rec] == ["model", "model"]


def test_model_axis_primitives_gradients():
    """``copy_in``: identity forward, all-reduce backward; ``reduce_out``:
    all-reduce forward, identity backward; ``gather_for_use``'s backward
    keeps the rank's slice over ``model`` (1-rank dry mesh values:
    all-reduce is the identity)."""
    mesh = DryMesh((1, 2), ("data", "model"))
    x = torch.ones(2, 3, requires_grad=True)
    y = collectives.copy_in(x, "model", mesh=mesh)
    (y * 2).sum().backward()
    assert torch.equal(x.grad, torch.full((2, 3), 2.0))
    w = torch.arange(6.0).reshape(2, 3).requires_grad_()
    full = collectives.gather_for_use(w, "model", 1, "slice", mesh=mesh)
    assert full.shape == (2, 6)
    (full * torch.arange(12.0).reshape(2, 6)).sum().backward()
    assert torch.equal(w.grad, torch.tensor([[0.0, 1, 2], [6, 7, 8]]))
