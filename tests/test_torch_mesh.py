"""The port's mesh-native train step over ``torch.distributed``.

One rank, in this process (a 1-rank gloo group):

* the toy of ``tests/torch_mesh_toy.py`` on a 1 x 1 mesh with f32 sync,
  under ``replicated``, ``fsdp`` and ``fsdp_q``, equals the port's
  meshless toy bit for bit (state and loss), and the collectives it
  issues are the ones each mode should (fsdp_q: the uint8 payload gather,
  no f32 gather of ``w``);
* the port's meshless toy against the reference's ``mesh_toy.run``: the
  loss and the bank bit for bit; ``w`` within one ulp and the AdamW
  moments within 1e-5 relative (the toy makes every cross-shard sum
  exact, not AdamW's rounding: XLA and torch round its update
  differently in the last bits — measured 1 ulp on 16 of ``w``'s 128
  values, 2e-6 relative (23 ulps) on ``m`` where the momentum cancels);
* reduced minicpm_2b on a 1 x 1 mesh, f32 sync, all three param modes:
  bit for bit the meshless step (state, losses, reductions);
* ``make_train_step``'s validations, as the reference's
  ``test_make_train_step_validations`` / ``_fsdp_validations``;
* the ``FSDPPayloadParam`` surface and the fsdp_q handoff's refusals.

Four gloo ranks (``tests/torch_mesh_cases.py``, one spawn):

* the toy with f32 sync on 4 x 1 under all three param modes equals one
  rank bit for bit, and the psum-aware clip equals the full clip;
* a checkpoint saved on 1 rank under fsdp restores on 4 ranks bit for bit
  and the 4-rank run continues onto the 1-rank state; the 4-rank
  checkpoint restores on 1 rank bit for bit;
* a (2, 2, 1) pod x data x model mesh: f32 and fsdp bit for bit, s2fp8
  finite; a (2, 2) data x model mesh, where the model axis replicates;
* the replicated-batch fallback divides an integer metric back;
* the compressed collectives on 4 ranks against the reference's
  ``compressed_allreduce_1d`` / ``compressed_grad_sync`` at 4 host
  devices, on ``tests/test_collectives.py``'s kind of inputs (2^17
  values x 1e-7 and a 100-element leaf, here from numpy seed 0);
* reduced minicpm_2b, s2fp8 sync and fsdp_q, 3 steps against the 1-rank
  meshless port, with the collective records and ``count_reductions``.

And the launcher under ``torchrun --nproc_per_node 2``.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import mesh_toy
import torch_mesh_cases as cases
import torch_mesh_toy as toy
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import collectives, statsbank
from repro_torch.core.policy import make_policy
from repro_torch.launch import mesh as lmesh
from repro_torch.optim import optimizers, schedules
from repro_torch.parallel import sharding
from repro_torch.training.trainer import make_train_step

jax.config.update("jax_platform_name", "cpu")

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def mesh1():
    """A 1-rank gloo group and a 1 x 1 mesh over it (the group is kept: a
    launcher test in this worker may reuse it)."""
    lmesh.init_distributed("cpu")
    return lmesh.make_mesh_from_spec("1x1")


@pytest.fixture(scope="module")
def meshless_toy():
    """The port's meshless toy: (full state leaves, losses) after 4 steps,
    and after 2."""
    full, losses, _, _, _ = cases.toy_run(None, steps=4)
    mid = cases.toy_run(None, steps=2)[0]
    return full, losses, mid


def _assert_leaves_equal(a, b, msg=""):
    assert len(a) == len(b), msg
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, (msg, i)
        np.testing.assert_array_equal(x, y, err_msg=f"{msg} leaf {i}")


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["replicated", "fsdp", "fsdp_q"])
def test_mesh1_toy_matches_meshless_bitwise(mesh1, meshless_toy, mode):
    full, losses, _, _, rec = cases.toy_run(mesh1, mode)
    _assert_leaves_equal(full, meshless_toy[0], mode)
    assert losses == meshless_toy[1]
    counts, _ = cases.summarize(rec)
    steps = 4
    # per step: the w gradient (f32, replicated only), the loss, and the
    # grad-norm partials under fsdp; the step-0 refresh adds two stats
    # all-reduces (f64) per site-direction that refreshed
    if mode == "replicated":
        assert "all_gather/float32" not in counts
        assert "all_gather/uint8" not in counts
    elif mode == "fsdp":
        assert counts["all_gather/float32"] >= steps    # gather of w
        assert "all_gather/uint8" not in counts
    else:
        assert counts["all_gather/uint8"] == steps      # w's payload
        assert "all_gather/float32" not in counts       # no wide gather
    assert counts["all_reduce/float64"] > 0             # global stats


def test_meshless_toy_matches_the_reference(meshless_toy):
    r_j = mesh_toy.run(*mesh_toy.setup()[:4], 4)
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(r_j[:3])]
    tl = meshless_toy[0]
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        if i == 0:              # w: one ulp at most
            ulps = np.abs(a.view(np.int32).astype(np.int64)
                          - b.view(np.int32).astype(np.int64))
            assert ulps.max() <= 1, ulps.max()
        elif i < 4:             # the AdamW step, m and v
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=0,
                                       err_msg=f"leaf {i}")
        else:                   # the bank
            np.testing.assert_array_equal(b, a, err_msg=f"leaf {i}")
    assert float(r_j[3]["loss"]) == meshless_toy[1][-1]


class _Stub:
    def __init__(self, axes, sizes):
        self.axis_names = axes
        self.shape = sizes


def test_make_train_step_validations():
    pol = make_policy("fp32")
    opt = optimizers.adamw()
    sched = schedules.constant(1e-3)
    with pytest.raises(ValueError, match="grad_sync_mode"):
        make_train_step(toy.loss_fn, opt, sched, pol, grad_sync_mode="bf16")
    mesh = _Stub(("data", "model"), {"data": 1, "model": 1})
    with pytest.raises(ValueError, match="grad_sync"):
        make_train_step(toy.loss_fn, opt, sched, pol, mesh=mesh,
                        grad_sync=lambda g: g)
    # the legacy hook runs on the meshless step's gradients
    seen = []
    step = make_train_step(toy.loss_fn, opt, sched, pol,
                           grad_sync=lambda g: seen.append(len(g)) or g)
    params = toy.make_params()
    step(params, opt.init(params), toy.make_batch(0), 0)
    assert seen == [1]


def test_make_train_step_fsdp_validations():
    pol_q = make_policy("s2fp8_e4m3", gemm_mode="payload")
    opt = optimizers.adamw()
    sched = schedules.constant(1e-3)
    scfg = statsbank.StatsConfig(refresh_every=64)
    with pytest.raises(ValueError, match="param_sharding"):
        make_train_step(toy.loss_fn, opt, sched, pol_q, stats=scfg,
                        param_sharding="zero3")
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(toy.loss_fn, opt, sched, pol_q, stats=scfg,
                        param_sharding="fsdp")
    mesh = _Stub(("data", "model"), {"data": 1, "model": 1})
    nofsdp = _Stub(("model",), {"model": 1})
    with pytest.raises(ValueError, match="fsdp"):
        make_train_step(toy.loss_fn, opt, sched, pol_q, stats=scfg,
                        mesh=nofsdp, param_sharding="fsdp")
    with pytest.raises(ValueError, match="fsdp_q"):
        make_train_step(toy.loss_fn, opt, sched, pol_q, mesh=mesh,
                        param_sharding="fsdp_q")
    with pytest.raises(ValueError, match="s2fp8"):
        make_train_step(toy.loss_fn, opt, sched, make_policy("fp32"),
                        mesh=mesh, stats=scfg, param_sharding="fsdp_q")
    make_train_step(toy.loss_fn, opt, sched, make_policy("fp32"),
                    mesh=mesh, param_sharding="fsdp")


def test_fsdp_payload_param_surface_and_refusals(mesh1):
    from repro_torch.core import qdot
    info = collectives.FSDPInfo("data", 1, (), "f32", 1 << 16, None,
                                mesh=mesh1)
    info = info._replace(gather_f32=collectives.make_param_gather(info))
    w = torch.randn(8, 16, requires_grad=True)
    fp = collectives.FSDPPayloadParam(w, info)
    assert fp.shape == (8, 16) and fp.dim() == 2 and fp.dtype == w.dtype
    assert fp.to(torch.float32) is fp and fp.float() is fp
    assert isinstance(fp.to(torch.bfloat16), collectives.FSDPPayloadParam)
    with collectives.bind(mesh1), collectives.recording() as rec:
        # every other use takes the f32 gather, gradients included
        y = (fp.T.sum() + fp[0].sum() + torch.sum(fp * 2.0)
             + torch.einsum("kn->", fp))
        g, = torch.autograd.grad(y, [w])
        want = torch.full_like(w, 4.0)
        want[0] += 1.0
        assert torch.equal(g, want)
        x = torch.randn(3, 8)
        with pytest.raises(ValueError, match="active StatsBank session"):
            qdot.qdot_train(x, fp, backend="plain")
        cfg = statsbank.StatsConfig(refresh_every=4)   # no axis_name
        bank = statsbank.init_bank(toy.loss_fn, toy.make_params(),
                                   toy.make_batch(0),
                                   make_policy("s2fp8_e4m3",
                                               gemm_mode="payload"), cfg)
        with statsbank.bind(bank, 0, cfg):
            with pytest.raises(ValueError, match="leaf-global stats"):
                qdot.qdot_train(torch.zeros(8, 8), fp, backend="plain")
    assert all(r["op"] == "all_gather" for r in rec)


# ---------------------------------------------------------------------------
# four ranks (one spawn) and the JAX reference of the compressed legs
# ---------------------------------------------------------------------------

_JAX_COLLECTIVES = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
jax.config.update("jax_platform_name", "cpu")
from repro.core.collectives import compressed_grad_sync, compressed_allreduce_1d
mesh = jax.make_mesh((4,), ("data",))
rng = np.random.RandomState(0)
g_big = (rng.standard_normal(1 << 17) * 1e-7).astype(np.float32)
g_small = (rng.standard_normal(100) * 1e-7).astype(np.float32)
red = jax.jit(lambda g: compressed_allreduce_1d(g, mesh, "data"))(g_big)
synced = jax.jit(lambda g: compressed_grad_sync(g, mesh, "data"))(
    {"big": g_big, "small": g_small})
np.savez(sys.argv[1], red=np.asarray(red), big=np.asarray(synced["big"]),
         small=np.asarray(synced["small"]))
"""


@pytest.fixture(scope="module")
def world4(tmp_path_factory, mesh1):
    """The 4-rank suite's results (rank 0), and the reference's compressed
    collectives at 4 host devices (run in parallel with it)."""
    work = str(tmp_path_factory.mktemp("world4"))
    ref = os.path.join(work, "jax_collectives.npz")
    env = dict(os.environ, PYTHONPATH=_SRC)
    jproc = subprocess.Popen([sys.executable, "-c", _JAX_COLLECTIVES, ref],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    # the 1-rank fsdp checkpoint the 4 ranks restore (after 2 steps)
    _, _, _, (p, o, b), _ = cases.toy_run(mesh1, "fsdp", steps=2)
    CheckpointManager(os.path.join(work, "ckpt_from_1"), mesh=mesh1).save(
        2, (p, o, b))
    try:
        out = cases.run_ranks("world4", 4, work)
        log = jproc.communicate(timeout=cases.TIMEOUT_S)[0]
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.communicate()
    assert jproc.returncode == 0, log[-3000:]
    with np.load(ref) as z:
        out["jax_collectives"] = {k: z[k] for k in z.files}
    out["work"] = work
    return out


@pytest.mark.parametrize("mode", ["replicated", "fsdp", "fsdp_q"])
def test_world4_toy_bitwise(world4, meshless_toy, mode):
    full, losses = world4[f"toy_{mode}"]
    _assert_leaves_equal(full, meshless_toy[0], mode)
    assert losses == meshless_toy[1]
    counts, largest = cases.summarize(world4[f"toy_{mode}_collectives"])
    if mode == "fsdp_q":
        # w (payload-eligible) crosses the wire only as its 1-byte payload
        assert counts["all_gather/uint8"] == 4 and largest[
            "all_gather/uint8"] == toy.K * toy.N_FEAT
        assert "all_gather/float32" not in counts
        assert counts["reduce_scatter/float32"] == 4      # dW to owners
    if mode == "fsdp":
        assert largest["all_gather/float32"] == toy.K * toy.N_FEAT


def test_world4_psum_clip(world4):
    g = {"a": torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16) - 60,
         "b": torch.arange(8, dtype=torch.float32)[:, None].repeat(1, 4) - 3}
    full, norm = optimizers.clip_by_global_norm(g, 1.0)
    clipped, snorm, _ = world4["clip"]
    assert snorm == float(norm)
    for k in g:
        np.testing.assert_array_equal(world4["clip_gathered"][k],
                                      full[k].numpy())
        np.testing.assert_array_equal(clipped[k], full[k].numpy()[:2])


def test_world4_checkpoints_cross_rank_counts(world4, meshless_toy, mesh1):
    assert world4["ckpt_restored_step"] == 2
    assert world4["ckpt_shard_shapes"] == [(2, 16)]
    _assert_leaves_equal(world4["ckpt_restored_state"], meshless_toy[2],
                         "1 -> 4 restore")
    _assert_leaves_equal(world4["ckpt_continued_state"], meshless_toy[0],
                         "4-rank continuation")
    # the 4-rank checkpoint on 1 rank, fsdp and meshless templates alike
    ck = CheckpointManager(os.path.join(world4["work"], "ckpt_from_4"),
                           mesh=mesh1)
    _, _, _, tmpl, _ = cases.toy_run(mesh1, "fsdp", steps=0)
    (p, o, b), got = ck.restore(tmpl)
    assert got == 4 and sharding.is_shard(p["w"])
    _assert_leaves_equal(cases.full_state(mesh1, p, o, b), meshless_toy[0],
                         "4 -> 1 restore")
    _, _, _, tmpl, _ = cases.toy_run(None, steps=0)
    (p, o, b), _ = CheckpointManager(
        os.path.join(world4["work"], "ckpt_from_4")).restore(tmpl)
    _assert_leaves_equal(cases.host_leaves((p, o, b)), meshless_toy[0],
                         "4 -> meshless restore")


def test_world4_pod_and_model_axes(world4, meshless_toy):
    for key in ("pod_f32", "pod_fsdp", "dm_f32"):
        full, losses = world4[key]
        _assert_leaves_equal(full, meshless_toy[0], key)
        assert losses == meshless_toy[1], key
    full, losses = world4["pod_s2fp8"]
    assert all(np.isfinite(x).all() for x in full if x.dtype.kind == "f")
    assert all(np.isfinite(losses))
    counts, _ = cases.summarize(world4["pod_s2fp8_collectives"])
    # w (128 elements, floor 64): the pod fold in f32, then the legs over
    # data; no f32 all-reduce of w's size
    big_f32 = [r for r in world4["pod_s2fp8_collectives"]
               if r["op"] == "all_reduce" and r["dtype"] == "float32"
               and r["numel"] >= 64 and r["axis"] != ("pod",)]
    assert not big_f32, big_f32
    assert counts["reduce_scatter/bfloat16"] == 4
    assert counts["all_gather/uint8"] == 4
    assert world4["dm_coords"]["model"] in (0, 1)


def test_world4_replicated_batch_divides_int_metrics_back(world4):
    assert world4["int_metric"] == [8, 6]


def _gap(a: np.ndarray, b: np.ndarray):
    """(median, max) relative gap between two decoded results, and the
    share of values a code apart: an e5m2 code step is at least 2^-2 of a
    value in the squeezed domain, far above 1e-2 after the unsqueeze at
    these stats, while a shift of (alpha, beta) alone moves every value by
    a few ulps."""
    nz = (a != 0) | (b != 0)
    rel = np.abs(a[nz] - b[nz]) / np.maximum(np.abs(b[nz]), 1e-30)
    return float(np.median(rel)), float(rel.max()), float((rel > 1e-2).mean())


def test_world4_compressed_collectives_against_the_reference(world4):
    """The compressed legs on 4 gloo ranks against the reference's at 4
    host devices on the same inputs.  The bf16 reduce-scatter sums 4 equal
    copies (exact on both sides); each side encodes its shard with its own
    exact stats, whose log2 sums differ in the last bits (XLA vs torch,
    ROADMAP queue 3), so every decoded value may move by a few ulps while
    the codes agree.  Budget: the reference's own bound against the exact
    sum (median relative error under 5%, over 90% nonzero); against the
    reference, median relative gap under 1e-5, max under 1e-4 and at most
    0.1% of the values a code apart (measured: 1.3e-6, 7.5e-6 and none);
    the plain 100-element leaf bit for bit."""
    red, big, small = world4["compressed"]
    ref = world4["jax_collectives"]
    rng = np.random.RandomState(0)
    g_big = (rng.standard_normal(1 << 17) * 1e-7).astype(np.float32)
    g_small = (rng.standard_normal(100) * 1e-7).astype(np.float32)
    exact = g_big.astype(np.float64) * 4
    nz = red != 0
    assert nz.mean() > 0.9
    assert np.median(np.abs(red[nz] - exact[nz]) / np.abs(exact[nz])) < 0.05
    for got, want in ((red, ref["red"]), (big, ref["big"])):
        med, mx, flips = _gap(got, want)
        assert med < 1e-5 and mx < 1e-4 and flips <= 1e-3, (med, mx, flips)
        assert ((got == 0) == (want == 0)).all()
    np.testing.assert_array_equal(small, ref["small"])
    np.testing.assert_allclose(small, g_small, rtol=1e-6, atol=0)
    counts, largest = cases.summarize(world4["compressed_collectives"])
    assert counts["reduce_scatter/bfloat16"] == 2         # red, big
    assert counts["all_gather/uint8"] == 2
    assert largest["all_gather/uint8"] == 1 << 17
    assert largest["all_reduce/float32"] == 100           # small only


@pytest.fixture(scope="module")
def minicpm_meshless():
    """The 1-rank meshless port on reduced minicpm: losses, the steady
    step's reduction count, the final state's leaves."""
    losses, _, n_red, (p, o, b) = cases.minicpm_run(None, mode="replicated")
    return losses, n_red, cases.host_leaves((p, o, b))


@pytest.mark.parametrize("mode", ["replicated", "fsdp", "fsdp_q"])
def test_mesh1_minicpm_matches_meshless_bitwise(mesh1, minicpm_meshless,
                                                mode):
    """Reduced minicpm_2b on a 1 x 1 mesh with f32 sync: losses, params,
    AdamW state and bank bit for bit the meshless step's, and as many
    scalar reductions in a steady step (what ``chip_smoke.py``'s
    train-mesh holds at full width on the card)."""
    losses, _, n_red, (p, o, b) = cases.minicpm_run(mesh1, mode=mode)
    assert losses == minicpm_meshless[0]
    assert n_red == minicpm_meshless[1]
    _assert_leaves_equal(cases.host_leaves((p, o, b)), minicpm_meshless[2],
                         mode)


def test_world4_minicpm_s2fp8_fsdp_q(world4, minicpm_meshless):
    """Reduced minicpm_2b on 4 ranks, s2fp8 sync (floor 1,024) and fsdp_q:
    losses within 2e-3 relative of the 1-rank meshless port at every step
    (measured 5.9e-4 under fsdp_q, 3.2e-4 replicated: the global stats'
    f64 sums shift a grid by an ulp here and there, and the bf16 legs
    round the gradients); every leaf a dim-0
    shard; no f32 all-reduce of a large leaf; the embedding (the only
    payload-eligible leaf: the segments' leaves are [L]-stacked 3-D) is
    gathered wide exactly twice a forward — in f32 for the embed site's
    truncation and in bf16 for the tied head (the port casts the table to
    the activations' dtype before the head GEMM, as its meshless step
    does; the reference's fallback gathers f32 there) — so no payload
    handoff happens on a tied model, in the reference either (the toy
    holds the handoff); and a steady step runs the meshless step's
    reductions."""
    losses, records, n_red, shapes, flags = world4["minicpm_fsdp_q"]
    ref_losses, ref_red, _ = minicpm_meshless
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-3)
    assert all(flags) and shapes[0] == (128, 128)     # embed [512, 128]
    assert n_red == ref_red
    for step_rec in records:
        big_f32 = [r for r in step_rec if r["op"] == "all_reduce"
                   and r["dtype"] == "float32" and r["numel"] >= 1 << 10]
        assert not big_f32, big_f32
        embed_gathers = [r["dtype"] for r in step_rec
                         if r["op"] == "all_gather"
                         and r["out_shape"] == (512, 128)]
        assert sorted(embed_gathers) == ["bfloat16", "float32"]
    # replicated s2fp8: every leaf of at least 1,024 elements takes the
    # legs (one bf16 reduce-scatter and one uint8 all-gather a leaf), and
    # a steady step adds only the encode's exact stats (3 reductions a
    # compressed leaf: sum, max and count)
    losses_r, records_r, n_red_r = world4["minicpm_replicated_s2fp8"]
    np.testing.assert_allclose(losses_r, ref_losses, rtol=2e-3)
    for step_rec in records_r:
        counts, _ = cases.summarize(step_rec)
        n_comp = counts["reduce_scatter/bfloat16"]
        assert counts["all_gather/uint8"] == n_comp > 0
        assert not [r for r in step_rec if r["op"] == "all_reduce"
                    and r["dtype"] == "float32" and r["numel"] >= 1 << 10]
    assert n_red_r == ref_red + 3 * n_comp


def test_launcher_under_torchrun(tmp_path):
    """``torchrun --nproc_per_node 2`` of the train launcher on the CPU,
    reduced minicpm, s2fp8 sync and fsdp_q, 2 steps: rank 0 alone prints
    the header, the mesh line and one JSON line per step."""
    env = dict(os.environ, PYTHONPATH=_SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--rdzv-backend", "c10d", "--rdzv-endpoint", "localhost:0",
         "-m", "repro_torch.launch.train", "--arch", "minicpm_2b",
         "--reduced", "--device", "cpu", "--steps", "2", "--batch", "4",
         "--seq", "32", "--stats-refresh-every", "2", "--grad-sync",
         "s2fp8", "--grad-sync-min-size", "1024", "--shard-params",
         "fsdp_q"],
        env=env, capture_output=True, text=True, timeout=cases.TIMEOUT_S,
        cwd=str(tmp_path))
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    lines = proc.stdout.splitlines()
    mesh_lines = [l for l in lines if l.startswith("[train] mesh")]
    assert mesh_lines == [
        "[train] mesh {'data': 2, 'model': 1}: 2-way data-parallel step, "
        "grad sync s2fp8, params fsdp_q (2-way over 'data'), 2 ranks (cpu)"]
    steps = [json.loads(l) for l in lines if l.startswith("{")]
    assert [s["step"] for s in steps] == [0, 1]
    assert all(np.isfinite(s["loss"]) for s in steps)


def test_launcher_flag_errors():
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match="needs a mesh"):
        train.parse_args(["--arch", "minicpm_2b", "--mesh", "none",
                          "--shard-params", "fsdp"])
    with pytest.raises(SystemExit, match="stats-refresh-every"):
        train.parse_args(["--arch", "minicpm_2b", "--shard-params",
                          "fsdp_q"])
    a = train.parse_args(["--arch", "minicpm_2b"])
    assert (a.mesh, a.grad_sync, a.grad_sync_min_size, a.shard_params) == \
        ("host", "f32", 1 << 16, "replicated")
