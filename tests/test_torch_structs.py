"""Slice 13: the shape grid, ``launch/api.py``'s struct half,
``roofline/analysis.py``, the numerics-engine registry and
``HostPrefetcher``, each held against the JAX package's on the CPU.

Tolerances: the grid, every config's skip reasons, the struct leaves
(shape and dtype, through ``convert.jax_leaves``' order) and
``model_flops`` are held equal for all 13 archs x 4 shapes; the one
difference is stated: the port's ``n_active_params`` counts a
``dense_first`` block, which the reference's formula skips, so for
deepseek_moe_16b and kimi_k2_1t_a32b the port's 6·N·D (2·N·D) is the
reference's plus exactly that block's params times the factor and the
tokens.
"""
import time

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import is_fake

from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import base as jcfg
from repro.core import backend as jbackend
from repro.launch import api as japi
from repro.roofline import analysis as janalysis
from repro_torch import convert
from repro_torch.configs import base as pcfg
from repro_torch.core import backend as nbackend
from repro_torch.core.policy import make_policy
from repro_torch.data import synthetic
from repro_torch.launch import api
from repro_torch.roofline import analysis

# the reference's dtypes -> the port's (token ids are int64 in the port)
DTYPES = {jnp.dtype("int32"): torch.int64, jnp.dtype("float32"):
          torch.float32, jnp.dtype("bfloat16"): torch.bfloat16}
# the reference's api covers the LM families only: both packages raise
# the same error for the paper's conv / mlp configs
NO_LM = ("resnet20_cifar", "ncf_ml1m")


def test_shape_grid_and_block_types_are_the_reference():
    assert pcfg.SHAPES == jcfg.SHAPES
    assert pcfg.SHAPE_SPECS == jcfg.SHAPE_SPECS
    assert pcfg.BLOCK_TYPES == jcfg.BLOCK_TYPES


@pytest.mark.parametrize("arch", pcfg.ARCH_IDS)
def test_skip_reasons_and_sub_quadratic_are_the_reference(arch):
    p, r = pcfg.get_config(arch), jcfg.get_config(arch)
    assert p.skip_shapes == r.skip_shapes
    assert p.sub_quadratic == r.sub_quadratic
    for shape in jcfg.SHAPES:
        assert p.skip_reason(shape) == r.skip_reason(shape), (arch, shape)


def _dense_first(cfg) -> int:
    return sum(cfg._block_params(b, 0) for b in cfg.resolved_pattern
               if b == "dense_first")


@pytest.mark.parametrize("arch", pcfg.ARCH_IDS)
def test_model_flops_is_the_reference(arch):
    p, r = pcfg.get_config(arch), jcfg.get_config(arch)
    for shape in jcfg.SHAPES:
        seq, gbs, kind = jcfg.SHAPE_SPECS[shape]
        factor = 6.0 if kind == "train" else 2.0
        tokens = (gbs if kind == "decode" else
                  (seq + 448) * gbs if p.enc_dec and kind == "train"
                  else seq * gbs)
        want = (janalysis.model_flops(r, shape)
                + factor * _dense_first(p) * tokens)
        assert analysis.model_flops(p, shape) == want, (arch, shape)
    assert (_dense_first(p) > 0) == (arch in ("deepseek_moe_16b",
                                              "kimi_k2_1t_a32b"))


def _leaves_match(jtree, ptree):
    jl, pl = jax.tree_util.tree_leaves(jtree), convert.jax_leaves(ptree)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        assert tuple(a.shape) == tuple(b.shape)
        assert DTYPES[jnp.dtype(a.dtype)] == b.dtype
        assert is_fake(b)


@pytest.mark.parametrize("arch", pcfg.ARCH_IDS)
def test_structs_are_the_reference(arch):
    p, r = pcfg.get_config(arch), jcfg.get_config(arch)
    if arch in NO_LM:
        with pytest.raises(ZeroDivisionError):
            japi.param_struct(r)
        with pytest.raises(ZeroDivisionError):
            api.param_struct(p)
    else:
        _leaves_match(japi.param_struct(r), api.param_struct(p))
        _leaves_match(japi.param_struct(r, dtype=jnp.bfloat16),
                      api.param_struct(p, dtype=torch.bfloat16))
    for shape in jcfg.SHAPES:
        _leaves_match(japi.batch_struct(r, shape), api.batch_struct(p, shape))
        jc = None if arch in NO_LM else japi.cache_struct(r, shape)
        pc = None if arch in NO_LM else api.cache_struct(p, shape)
        assert (jc is None) == (pc is None), (arch, shape)
        if jc is not None:
            _leaves_match(jc, pc)


def test_kimi_struct_is_a_trillion_fake_elements():
    """1.03 T elements in fake tensors: no leaf holds memory (each is a
    FakeTensor over meta storage), and building it takes seconds."""
    t0 = time.perf_counter()
    params = api.param_struct(pcfg.get_config("kimi_k2_1t_a32b"))
    leaves = convert.jax_leaves(params)
    assert sum(x.numel() for x in leaves) > 0.9e12
    assert all(is_fake(x) for x in leaves)
    assert all(x.untyped_storage().device.type == "meta" for x in leaves)
    assert time.perf_counter() - t0 < 60


def test_registry_contents():
    names = nbackend.available_backends()
    assert names == ("cuda", "cuda_fused", "plain")
    assert nbackend.get_backend("plain").name == "plain"
    assert nbackend.get_backend("cuda").name == "cuda"
    # "auto" / None resolve to the default engine: the kernels
    assert nbackend.default_backend_name() == "cuda"
    assert nbackend.get_backend("auto").name == \
        nbackend.default_backend_name()
    assert nbackend.get_backend(None).name == nbackend.default_backend_name()
    # the reference registers its own names, and neither sees the other's
    assert "plain" not in jbackend.available_backends()


def test_registry_rejects_unknown_and_duplicate():
    with pytest.raises(KeyError):
        nbackend.get_backend("pallas")
    with pytest.raises(ValueError):
        nbackend.register_backend("plain", nbackend.PlainBackend())
    with pytest.raises(ValueError):
        make_policy("s2fp8", backend="int4")
    # overwrite=True replaces, and a policy may then name the engine
    eng = nbackend.register_backend("plain_extra", nbackend.PlainBackend())
    try:
        assert "plain_extra" in nbackend.available_backends()
        assert make_policy("s2fp8", backend="plain_extra").backend_obj \
            is eng
        again = nbackend.PlainBackend()
        nbackend.register_backend("plain_extra", again, overwrite=True)
        assert nbackend.get_backend("plain_extra") is again
    finally:
        del nbackend.BACKENDS["plain_extra"]


def test_host_prefetcher_batches_equal_direct_generation():
    """The reference's prefetcher over the launchers' (seed, step) batches:
    every batch equals direct generation, in order, and a step taken out of
    order still gets its own batch."""
    chain = synthetic.markov_chain(0, 64)

    def gen(step):
        g = torch.Generator().manual_seed(1000 + step)
        return synthetic.lm_batch(chain, g, 2, 8, "cpu")

    pf = synthetic.HostPrefetcher(gen, n_prefetch=3)
    try:
        for s in list(range(6)) + [9, 8]:
            got = pf.get(s)
            want = gen(s)
            assert all(torch.equal(got[k], want[k]) for k in want), s
    finally:
        pf.close()


def test_card_constants_and_bound():
    """The card's data-sheet rates, one copy (``chip_smoke.py`` imports
    them), and the per-call bound: bytes over HBM against f32 or
    3 x TF32 operations."""
    assert analysis.PEAK_FLOPS == 989.4e12
    assert analysis.TF32_FLOPS == 494.7e12
    assert analysis.F32_FLOPS == 67e12
    assert analysis.HBM_BW == 3.35e12
    assert analysis.LINK_BW == 450e9
    ms, by, kind = analysis.bound_ms(3.35e9, 0.0)
    assert (ms, by, kind) == (1.0, "bytes", "f32 cores")
    ms, by, kind = analysis.bound_ms(0.0, 67e9)
    assert (ms, by) == (1.0, "operations")
    ms, by, kind = analysis.bound_ms(0.0, 494.7e9, tensor_cores=True)
    assert ms == pytest.approx(3.0) and kind == "3xTF32 tensor cores"


def test_roofline_terms():
    """``analyze`` over a trace cost: the three terms, the dominant one,
    and mfu at 6·N·D over the card's bf16 peak."""
    from repro_torch.roofline.trace_cost import TraceCost
    cost = TraceCost(flops=989.4e12, bytes=3.35e12 * 2, coll_bytes=450e9,
                     coll={"all_reduce": 450e9})
    rl = analysis.analyze("a", "s", "1", 2, cost, 1e9, 989.4e3)
    d = rl.to_dict()
    assert d["compute_s"] == pytest.approx(1.0)
    assert d["memory_s"] == pytest.approx(2.0)
    assert d["collective_s"] == pytest.approx(1.0)
    assert d["dominant"] == "memory" and d["step_s"] == pytest.approx(2.0)
    assert d["useful_flops_frac"] == pytest.approx(0.5)
    assert d["mfu"] == pytest.approx(0.25)
    assert set(d) == set(janalysis.Roofline(
        "a", "s", "1", 1, 0, 0, 0, {}, 0, 0).to_dict())
