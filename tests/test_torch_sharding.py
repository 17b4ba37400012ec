"""The port's parallel spec arithmetic against the reference's, one process,
no process group: the rule tables, ``resolve`` / ``guarded_spec``, the
batch and FSDP specs, ``train_step_specs``, ``statsbank.for_mesh``,
``launch/api.py``'s PartitionSpec rules over every ported config's reduced
tree, ``make_mesh_from_spec``'s errors, ``leaf_sync_route`` over a grid,
and memplan's ``plan_leaf`` / ``plan_state`` / ``plan_arch``.

Each result is compared with the JAX function's on the same input; the
port's ``PartitionSpec`` is a tuple and is compared with JAX's ``P`` as
one.
"""
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs.base import get_reduced_config as jax_reduced
from repro.core import collectives as jcoll
from repro.core import statsbank as jsb
from repro.launch import api as japi
from repro.launch import memplan as jmemplan
from repro.launch import mesh as jmesh
from repro.parallel import sharding as jshd
from repro.models import transformer as jtlm
from repro.models import encdec as jencdec
from repro_torch.configs.base import get_reduced_config
from repro_torch.core import collectives as tcoll
from repro_torch.core import statsbank as tsb
from repro_torch.launch import api as tapi
from repro_torch.launch import memplan as tmemplan
from repro_torch.launch import mesh as tmesh
from repro_torch.models import encdec as tencdec
from repro_torch.models import transformer as ttlm
from repro_torch.parallel import sharding as tshd

jax.config.update("jax_platform_name", "cpu")

MESHES = [(("data", "model"), {"data": 8, "model": 1}),
          (("data", "model"), {"data": 4, "model": 2}),
          (("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16}),
          (("model",), {"model": 4})]

ARCHS = ("minicpm_2b", "stablelm_12b", "gemma3_1b", "nemotron_4_340b",
         "zamba2_1p2b", "deepseek_moe_16b", "kimi_k2_1t_a32b",
         "chameleon_34b", "falcon_mamba_7b", "whisper_medium",
         "transformer_tiny")


def _stub(axes, sizes):
    return types.SimpleNamespace(axis_names=axes, shape=dict(sizes))


def _tup(spec):
    return tuple(spec)


def _jleaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _tleaves(tree):
    """Port spec trees in JAX's leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tleaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _tleaves(v)]
    return [tree]


def test_rule_tables_are_the_references():
    assert tshd.TRAIN_RULES == jshd.TRAIN_RULES
    assert tshd.DECODE_RULES == jshd.DECODE_RULES
    assert tshd.PartitionSpec("data", None, ("pod", "data")) == \
        tuple(jax.sharding.PartitionSpec("data", None, ("pod", "data")))


LOGICAL = [("batch", "seq", "embed"), ("batch", "heads", None, "kv"),
           ("embed", "mlp"), ("expert", "embed", "mlp"), ("vocab", "embed"),
           ("batch", "kv_seq", "kv"), ("fsdp", "mlp"), ("batch", "batch")]
SHAPES = [(16, 64, 128), (8, 36, 7, 64), (2048, 5760), (64, 2048, 1408),
          (122753, 2304), (8, 1024, 64), (6, 10), (4, 4)]


@pytest.mark.parametrize("rules", ["train", "decode"])
@pytest.mark.parametrize("axes,sizes", MESHES)
def test_resolve_and_guarded_spec(rules, axes, sizes):
    jr = jshd.TRAIN_RULES if rules == "train" else jshd.DECODE_RULES
    tr = tshd.TRAIN_RULES if rules == "train" else tshd.DECODE_RULES
    assert tshd.resolve("batch") == () and not tshd.active()
    with jshd.use_rules(jr, sizes), tshd.use_rules(tr, sizes):
        assert tshd.active()
        for logical, shape in zip(LOGICAL, SHAPES):
            assert _tup(tshd.resolve(*logical)) == \
                _tup(jshd.resolve(*logical)), logical
            assert _tup(tshd.guarded_spec(shape, *logical)) == \
                _tup(jshd.guarded_spec(shape, *logical)), (logical, shape)
        with tshd.suspend_rules():
            assert not tshd.active()
        x = torch.zeros(2, 3)
        assert tshd.shard(x, "batch", "embed") is x
        with pytest.raises(ValueError, match="axes for rank-2"):
            tshd.shard(x, "batch")


BATCHES = [{"tokens": (16, 64), "labels": (16,), "scalar": ()},
           {"tokens": (16, 64), "odd": (6, 4)},
           {"x": (8, 8), "t": (8, 16)},
           {"s": ()}]


@pytest.mark.parametrize("axes,sizes", MESHES)
def test_batch_and_fsdp_specs(axes, sizes):
    jm, tm = _stub(axes, sizes), _stub(axes, sizes)
    assert tshd.mesh_batch_axes(tm) == jshd.mesh_batch_axes(jm)
    assert tshd.mesh_batch_size(tm) == jshd.mesh_batch_size(jm)
    assert tshd.fsdp_axis_entry(tm) == jshd.fsdp_axis_entry(jm)
    assert tshd.fsdp_axis_size(tm) == jshd.fsdp_axis_size(jm)
    for b in BATCHES:
        jb = {k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in b.items()}
        tb = {k: torch.zeros(v, dtype=torch.int32) for k, v in b.items()}
        assert tshd.batch_is_sharded(tb, tm) == jshd.batch_is_sharded(jb, jm)
        js, ts = jshd.mesh_batch_specs(jb, jm), tshd.mesh_batch_specs(tb, tm)
        assert {k: _tup(v) for k, v in ts.items()} == \
            {k: _tup(v) for k, v in js.items()}
    jt = {"w": jax.ShapeDtypeStruct((8, 16), jnp.float32),
          "bias": jax.ShapeDtypeStruct((6,), jnp.float32),
          "count": jax.ShapeDtypeStruct((), jnp.int32),
          "h": jax.ShapeDtypeStruct((32, 4), jnp.bfloat16)}
    tt = {"w": torch.zeros(8, 16), "bias": torch.zeros(6),
          "count": torch.zeros((), dtype=torch.int32),
          "h": torch.zeros(32, 4, dtype=torch.bfloat16)}
    js, ts = jshd.fsdp_param_specs(jt, jm), tshd.fsdp_param_specs(tt, tm)
    assert {k: _tup(v) for k, v in ts.items()} == \
        {k: _tup(v) for k, v in js.items()}
    batch_j = {"x": jax.ShapeDtypeStruct((8, 8), jnp.float32)}
    batch_t = {"x": torch.zeros(8, 8)}
    for mode in ("replicated", "fsdp"):
        for ws, wg in itertools.product((False, True), repeat=2):
            jin, jout = jshd.train_step_specs(
                batch_j, jm, with_stats=ws, with_guard=wg,
                param_sharding=mode, params=jt, opt_state={"m": jt})
            tin, tout = tshd.train_step_specs(
                batch_t, tm, with_stats=ws, with_guard=wg,
                param_sharding=mode, params=tt, opt_state={"m": tt})
            assert [_tup(x) for x in _tleaves(list(tin))] == \
                [_tup(x) for x in _jleaves(jin)]
            assert [_tup(x) for x in _tleaves(list(tout))] == \
                [_tup(x) for x in _jleaves(jout)]
    with pytest.raises(ValueError, match="concrete params"):
        tshd.train_step_specs(batch_t, tm, param_sharding="fsdp")


def test_fsdp_leaf_eligibility_and_for_mesh():
    cases = [((8, 16), 8), ((8,), 4), ((), 8), ((6, 4), 4), ((6, 4), 1),
             ((0, 3), 1)]
    dts = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
           (jnp.int32, torch.int32)]
    for (shape, n), (jd, td) in itertools.product(cases, dts):
        assert tshd.fsdp_leaf_eligible(shape, td, n) == \
            jshd.fsdp_leaf_eligible(shape, jd, n), (shape, n, jd)
    cfg_t = tsb.StatsConfig(refresh_every=4)
    cfg_j = jsb.StatsConfig(refresh_every=4)
    assert tsb.for_mesh(cfg_t, None).axis_name is None
    for axes, sizes in MESHES:
        assert tsb.for_mesh(cfg_t, _stub(axes, sizes)).axis_name == \
            jsb.for_mesh(cfg_j, _stub(axes, sizes)).axis_name
    assert tsb.StatsConfig(axis_name=["pod", "data"]).axis_name == \
        ("pod", "data")


def test_shard_batch_and_trees_on_a_stub_mesh():
    """The rank's batch slice (pod-major) and the dim-0 param shards."""
    for coords, want in (({"pod": 0, "data": 0}, 0), ({"pod": 0, "data": 1}, 1),
                         ({"pod": 1, "data": 0}, 2), ({"pod": 1, "data": 1}, 3)):
        m = types.SimpleNamespace(
            axis_names=("pod", "data", "model"),
            shape={"pod": 2, "data": 2, "model": 1},
            coords=dict(coords, model=0))
        b = {"x": torch.arange(16).reshape(8, 2), "s": torch.tensor(3)}
        got = tshd.shard_batch(b, m)
        assert torch.equal(got["x"], b["x"][2 * want:2 * want + 2])
        assert got["s"] is b["s"]
        p = {"w": torch.arange(8.0).reshape(4, 2), "b": torch.zeros(3),
             "i": torch.zeros(4, dtype=torch.int32)}
        sh = tshd.shard_tree(p, m, "fsdp")      # fsdp axis: data (2-way)
        c = coords["data"]
        assert torch.equal(sh["w"], p["w"][2 * c:2 * c + 2])
        assert tshd.is_shard(sh["w"]) and not tshd.is_shard(sh["b"])
        assert sh["b"] is p["b"] and sh["i"] is p["i"]
        assert tshd.shard_flags(sh) == [False, False, True]
        assert tshd.shard_tree(p, m, "replicated") is p
    ragged = {"x": torch.zeros(6, 2)}
    assert tshd.shard_batch(ragged, m) is ragged


def _cfg_pair(arch):
    return jax_reduced(arch), get_reduced_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_api_pspecs_match_the_reference(arch):
    jcfg, tcfg = _cfg_pair(arch)
    jstruct = japi.param_struct(jcfg)
    tparams = tapi.init_params(tcfg, seed=0, device="cpu")
    jl = jax.tree_util.tree_leaves(jstruct)
    tl = _tleaves(tparams)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    for axes, sizes in MESHES:
        js = _jleaves(japi.param_pspecs(jcfg, jstruct, sizes))
        ts = _tleaves(tapi.param_pspecs(tcfg, tparams, sizes))
        assert [_tup(x) for x in ts] == [_tup(x) for x in js], (arch, sizes)
        bj = {"tokens": jax.ShapeDtypeStruct((16, 64), jnp.int32),
              "labels": jax.ShapeDtypeStruct((6, 64), jnp.int32),
              "s": jax.ShapeDtypeStruct((), jnp.int32)}
        bt = {k: torch.zeros(v.shape, dtype=torch.int32)
              for k, v in bj.items()}
        assert {k: _tup(v) for k, v in
                tapi.batch_pspecs(bt, sizes).items()} == \
            {k: _tup(v) for k, v in japi.batch_pspecs(bj, sizes).items()}
        if jcfg.enc_dec:
            jc = jax.eval_shape(lambda: jencdec.init_dec_caches(jcfg, 4, 32))
            tc = tencdec.init_dec_caches(tcfg, 4, 32, device="cpu")
        else:
            jc = jax.eval_shape(lambda: jtlm.init_caches(jcfg, 4, 32))
            tc = ttlm.init_caches(tcfg, 4, 32, device="cpu")
        for kv_seq in (True, False):
            js = _jleaves(japi.cache_pspecs(jcfg, jc, sizes, kv_seq))
            ts = _tleaves(tapi.cache_pspecs(tcfg, tc, sizes, kv_seq))
            assert [_tup(x) for x in ts] == [_tup(x) for x in js], \
                (arch, sizes, kv_seq)


def test_make_mesh_from_spec_errors():
    for bad, match in (("abc", "mesh spec"), ("1x1x1x1", "factors"),
                       ("8", "factors"), ("2xq", "mesh spec")):
        with pytest.raises(ValueError, match=match) as te:
            tmesh.make_mesh_from_spec(bad)
        with pytest.raises(ValueError, match=match) as je:
            jmesh.make_mesh_from_spec(bad)
        assert str(te.value) == str(je.value)
    assert tmesh.parse_mesh_spec("2x4x1") == ((2, 4, 1),
                                              ("pod", "data", "model"))
    assert tmesh.parse_mesh_spec("8X1") == ((8, 1), ("data", "model"))


ROUTE_SHAPES = [(), (1,), (100,), (1 << 16,), (1 << 17,), (3, 1 << 15),
                (256, 256), (255, 257), (7, 7, 1337), (1 << 10, 1 << 6)]


@pytest.mark.parametrize("dt", [(jnp.float32, torch.float32),
                                (jnp.bfloat16, torch.bfloat16),
                                (jnp.int32, torch.int32),
                                (jnp.bool_, torch.bool)])
def test_leaf_sync_route_grid(dt):
    jd, td = dt
    for shape, n, floor in itertools.product(
            ROUTE_SHAPES, (1, 2, 3, 4, 8, 16), (1, 64, 1 << 10, 1 << 16)):
        assert tcoll.leaf_sync_route(shape, td, n, floor) == \
            jcoll.leaf_sync_route(shape, jd, n, floor), (shape, n, floor)


def test_memplan_plan_leaf_and_state():
    dts = [("float32", torch.float32, jnp.float32),
           ("bfloat16", torch.bfloat16, jnp.bfloat16),
           ("int32", torch.int32, jnp.int32)]
    shapes = [(), (8,), (6, 4), (122753, 2304), (40, 2304, 5760), (16, 16)]
    for shape, (_, td, jd), n, mode in itertools.product(
            shapes, dts, (1, 2, 8, 16), tmemplan.MODES):
        assert tmemplan.plan_leaf(shape, td, n, mode).__dict__ == \
            jmemplan.plan_leaf(shape, np.dtype(jd), n, mode).__dict__
    with pytest.raises(ValueError, match="mode"):
        tmemplan.plan_leaf((4,), torch.float32, 2, "zero3")
    tp = {"a": torch.zeros(8, 4), "b": torch.zeros(6),
          "c": torch.zeros(16, 3, dtype=torch.bfloat16)}
    jp = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32
                                  if v.dtype == torch.float32
                                  else jnp.bfloat16) for k, v in tp.items()}
    for n, mode in itertools.product((1, 2, 8), tmemplan.MODES):
        assert tmemplan.plan_state(tp, {"m": tp}, n, mode) == \
            jmemplan.plan_state(jp, {"m": jp}, n, mode)
    assert tmemplan.HBM_PER_CHIP_GB == 80.0
    assert tmemplan.fsdp_shards_of({"data": 4, "model": 2}) == 4


BYTE_FIELDS = ("param_store_bytes", "opt_store_bytes", "steady_bytes",
               "gather_peak_bytes", "gather_sum_bytes", "peak_bytes",
               "n_leaves", "n_sharded", "n_payload")


@pytest.mark.parametrize("arch", ["minicpm_2b", "deepseek_moe_16b",
                                  "zamba2_1p2b", "whisper_medium"])
def test_memplan_plan_arch_bytes(arch):
    """Byte fields of ``plan_arch`` at n 1, 8 and 16 against the
    reference's (their verdicts differ by design: 80 GB against 16): the
    reference's full-size structs are traced once an arch and planned in
    every mode, and ``plan_arch`` itself is held once."""
    from repro.configs.base import get_config as jax_config
    from repro.optim import optimizers as joptim
    params, opt = tmemplan.arch_state(arch)
    jparams = japi.param_struct(jax_config(arch))
    jopt = jax.eval_shape(joptim.adamw().init, jparams)
    for n, mode in itertools.product((1, 8, 16), tmemplan.MODES):
        want = jmemplan.plan_state(jparams, jopt, n, mode)
        got = tmemplan.plan_state(params, opt, n, mode)
        assert {k: got[k] for k in BYTE_FIELDS} == \
            {k: want[k] for k in BYTE_FIELDS}, (arch, n, mode)
    p = tmemplan.plan_arch(arch, 8, "fsdp_q")
    want = jmemplan.plan_arch(arch, 8, "fsdp_q")
    assert {k: p[k] for k in BYTE_FIELDS} == {k: want[k] for k in BYTE_FIELDS}
    assert p["hbm_gb"] == 80.0 and p["fits"] == (
        p["peak_bytes"] <= 80 * 2 ** 30)
    assert "HBM 80 GB/card" in tmemplan.format_report([arch], {"data": 8})
