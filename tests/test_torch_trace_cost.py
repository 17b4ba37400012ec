"""Slice 13: ``roofline/trace_cost.py``, the port's cost counter, held
against the reference's static HLO analyzer and against itself.

Tolerances and measured values (reduced minicpm_2b, batch 2 x 64, remat
off, s2fp8):

  * matmul FLOPs against ``repro.roofline.hlo_cost.cost_of`` over the JAX
    ``ref`` engine's compiled step on the CPU, within 2%.  In payload mode
    the raw gap is -4.72% (train) and -4.47% (prefill): the reference's
    ``ref`` flash node computes the full S x S score square and masks it,
    the kernel the port charges does the visible (causal) pairs only.
    With the masked pairs added back (4·d a pair forward, 10·d backward,
    per head) the gap is 0.0 in both; in fig4 mode (both packages run the
    same f32 products) the raw gap is 0.0.
  * a fake-tensor trace and a real-tensor trace of the same step are
    equal bit for bit: FLOPs, bytes, collective bytes, argument and peak
    live bytes, per-kind kernel calls and aten op counts.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import base as jcfg
from repro.core.policy import make_policy as jmake_policy
from repro.launch import api as japi
from repro.models import transformer as jtlm
from repro.roofline import hlo_cost
from repro_torch.configs.base import get_reduced_config
from repro_torch.core import collectives, statsbank
from repro_torch.core.policy import make_policy
from repro_torch.launch import api
from repro_torch.launch.mesh import DryMesh
from repro_torch.models import transformer as tlm
from repro_torch.parallel import sharding as shd
from repro_torch.roofline import trace_cost as tc

B, S = 2, 64
HLO_RTOL = 0.02


def _jax_flops(kind, gemm_mode):
    cfg = jcfg.get_reduced_config("minicpm_2b").replace(remat=False)
    pol = jmake_policy("s2fp8", backend="ref", gemm_mode=gemm_mode)
    params = japi.init_params(cfg, jax.random.PRNGKey(0))
    toks = jnp.zeros((B, S), jnp.int32)
    if kind == "train":
        step, opt = japi.make_train_step(cfg, pol)
        lowered = jax.jit(step).lower(params, opt.init(params),
                                      {"tokens": toks, "labels": toks},
                                      jnp.int32(0))
    else:
        caches = jtlm.init_caches(cfg, B, S, dtype=jnp.bfloat16)
        lowered = jax.jit(japi.make_prefill_step(cfg, pol)).lower(
            params, {"tokens": toks}, caches)
    return hlo_cost.cost_of(lowered.compile().as_text()).flops


def _port_cost(kind, gemm_mode, fake=True, cfg=None):
    cfg = cfg or get_reduced_config("minicpm_2b").replace(remat=False)
    pol = make_policy("s2fp8", backend="cuda" if gemm_mode == "payload"
                      else "plain", gemm_mode=gemm_mode)
    if fake:
        params = api.param_struct(cfg)
    else:
        params = api.init_params(cfg, seed=0, device="cpu")
    with api.fake_mode() if fake else _Null():
        toks = torch.zeros((B, S), dtype=torch.int64)
        if kind == "train":
            step, opt = api.make_train_step(cfg, pol)
            ostate = opt.init(params)
            args = (params, ostate, {"tokens": toks, "labels": toks})
            with tc.trace_cost(args) as cost:
                step(*args, 0)
        else:
            caches = tlm.init_caches(cfg, B, S, device="cpu",
                                     dtype=torch.bfloat16)
            args = (params, {"tokens": toks}, caches)
            with torch.no_grad(), tc.trace_cost(args) as cost:
                api.make_prefill_step(cfg, pol)(*args)
    return cost


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _masked_pairs_flops(cfg, kind):
    """The score pairs the reference's ``ref`` flash node computes and
    masks: (S^2 - S(S+1)/2) a head, 4·d forward and 10·d backward."""
    per_pair = 4.0 + (10.0 if kind == "train" else 0.0)
    masked = S * S - S * (S + 1) // 2
    return (per_pair * cfg.resolved_head_dim * masked * B * cfg.n_heads
            * cfg.n_layers)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_matmul_flops_within_2pct_of_hlo_cost(kind):
    cfg = get_reduced_config("minicpm_2b").replace(remat=False)
    want = _jax_flops(kind, "payload")
    cost = _port_cost(kind, "payload")
    assert cost.calls["qflash_fwd"] == cfg.n_layers
    raw_gap = cost.flops / want - 1.0
    assert -0.05 < raw_gap < -0.04, raw_gap          # measured -4.72 / -4.47%
    gap = (cost.flops + _masked_pairs_flops(cfg, kind)) / want - 1.0
    assert abs(gap) <= HLO_RTOL, gap                 # measured 0.0


def test_fig4_matmul_flops_equal_hlo_cost():
    """fig4 prefill: both packages run the same f32 products (aten matmuls
    on the port's side, dots on the reference's)."""
    want = _jax_flops("prefill", "fig4")
    cost = _port_cost("prefill", "fig4")
    assert cost.calls == {}
    assert abs(cost.flops / want - 1.0) <= HLO_RTOL
    assert cost.flops == want                         # measured: equal


def _same(a, b):
    da, db = a.to_dict(), b.to_dict()
    da.pop("seconds"), db.pop("seconds")
    assert da == db


def test_fake_trace_equals_real_trace_train_with_remat():
    cfg = get_reduced_config("minicpm_2b")            # remat on
    assert cfg.remat
    fake = _port_cost("train", "payload", fake=True, cfg=cfg)
    real = _port_cost("train", "payload", fake=False, cfg=cfg)
    _same(fake, real)
    assert fake.peak_bytes > fake.argument_bytes > 0
    assert set(fake.calls) >= {"quant_apply", "truncate_apply", "qmatmul_nn",
                               "qmatmul_nt", "qmatmul_tn", "qflash_fwd",
                               "qflash_bwd", "dequant"}


def test_fake_trace_equals_real_trace_prefill():
    cfg = get_reduced_config("minicpm_2b")
    _same(_port_cost("prefill", "payload", fake=True, cfg=cfg),
          _port_cost("prefill", "payload", fake=False, cfg=cfg))


def _fsdp_q_cost(fake):
    """Reduced minicpm's fsdp_q train step on a 4 x 2 dry mesh (rank 0;
    the collectives record and move nothing), with the bank fsdp_q
    needs."""
    cfg = get_reduced_config("minicpm_2b")
    mesh = DryMesh((4, 2), ("data", "model"))
    pol = make_policy("s2fp8", backend="cuda")
    stats = statsbank.StatsConfig()
    params = (api.param_struct(cfg) if fake
              else api.init_params(cfg, seed=0, device="cpu"))
    with api.fake_mode() if fake else _Null():
        toks = torch.zeros((8, 32), dtype=torch.int64)
        batch = {"tokens": toks, "labels": toks}
        bank = statsbank.init_bank(api.make_loss_fn(cfg), params, batch, pol,
                                   stats)
        step, opt = api.make_train_step(cfg, pol, stats=stats, mesh=mesh,
                                        param_sharding="fsdp_q")
        params = shd.shard_tree(params, mesh, "fsdp_q")
        ostate = shd.mark_opt_state(opt.init(params), params)
        with collectives.recording() as rec, \
                tc.trace_cost((params, ostate, bank, batch)) as cost:
            step(params, ostate, bank, batch, 0)
    return cost, rec


def test_fake_trace_equals_real_trace_fsdp_q_on_a_dry_mesh():
    fake, rec = _fsdp_q_cost(True)
    real, _ = _fsdp_q_cost(False)
    _same(fake, real)
    # the reference's multipliers over the records: all-reduce 2x its
    # result, all-gather 1x its result, reduce-scatter 1x its operand
    want = {}
    for r in rec:
        nb = (r["numel"] if r["op"] == "reduce_scatter" else r["out_numel"])
        nb *= getattr(torch, r["dtype"]).itemsize
        want[r["op"]] = want.get(r["op"], 0.0) + nb * tc.COLL_MULT[r["op"]]
    assert fake.coll == want and fake.coll_bytes == sum(want.values())
    assert {"all_gather", "reduce_scatter", "all_reduce"} <= set(fake.coll)


def test_dry_mesh_collectives_record_and_move_nothing():
    mesh = DryMesh((2, 16, 16), ("pod", "data", "model"))
    assert mesh.size == 512 and mesh.coords == {"pod": 0, "data": 0,
                                                "model": 0}
    x = torch.ones(32, 4)
    with collectives.recording() as rec:
        assert collectives.all_reduce(x, ("pod", "data"), mesh=mesh) is x
        rs = collectives.reduce_scatter(x, "data", mesh=mesh)
        ag = collectives.all_gather(x, "model", mesh=mesh)
    assert rs.shape == (2, 4) and ag.shape == (512, 4)
    assert [r["op"] for r in rec] == ["all_reduce", "reduce_scatter",
                                      "all_gather"]


def test_a_kernel_refuses_a_fake_tensor():
    """A fake tensor holds no memory: the kernel wrappers' operand check
    raises before any pointer is read."""
    from repro_torch.kernels.s2fp8_quant import check_cuda_operand
    with api.fake_mode():
        x = torch.empty(4)
    with pytest.raises(TypeError, match="fake tensor"):
        check_cuda_operand(x, "x", (torch.float32,))


def test_visible_pairs():
    assert tc.visible_pairs(4, 4, True, 0) == 10
    assert tc.visible_pairs(4, 4, False, 0) == 16
    assert tc.visible_pairs(4, 4, True, 2) == 7
    assert tc.visible_pairs(2, 4, True, 0) == 7        # rows end-aligned
