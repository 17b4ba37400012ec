"""The batched payload GEMM of the port and its planner against the JAX
package, on the CPU.

``qmatmul_batched`` takes its plain version for CPU tensors, so these
tests run the wrapper itself (launch / plain-call counts checked) against
``repro.kernels.ref.s2fp8_matmul_batched_ref`` on payloads made on the
JAX side and shared bit for bit: every layout, a broadcast A (Ga < G), a
broadcast B (Gb < G), a group sum (out_batch < G), with and without the
Eq. 5 epilogue, at ragged M/K/N.  Tolerances and their reasons:

  * raw outputs: within 1e-5 * max|ref| (f32 sums in another order);
  * with the epilogue: output codes at most one grid step apart, in at
    most 1e-3 of the outputs (an f32 rounding difference, or torch's and
    XLA's last-ulp log2/exp2, landing on a boundary of the output grid).
    The port's 2-D GEMM tests hold the same budget; measured here: one
    flip in 1,920 outputs (5.2e-4) in one case, none in the others.

The planner (``backend.plan_einsum`` / ``plan_qdot_general``) accepts and
rejects the reference's spec table (tests/test_qdot_batched.py) with the
same plans, and a plan run on payloads equals the einsum of their values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.core import s2fp8 as js2
from repro.core.policy import make_policy as jax_policy
from repro.kernels import ref as jref
from repro_torch import kernels
from repro_torch.core import backend as tbackend
from repro_torch.core import qdot as tqdot
from repro_torch.core import s2fp8 as ts2
from repro_torch.core.policy import make_policy
from repro_torch.kernels import dispatch, s2fp8_matmul
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

M, K, N = 24, 40, 20


def _ordinal(codes_u8: np.ndarray) -> np.ndarray:
    u = codes_u8.astype(np.int32)
    return np.where(u >= 0x80, -(u & 0x7F), u & 0x7F)


def _grid_steps(a, b, ab) -> np.ndarray:
    def codes(v):
        return ts2.quantize(torch.from_numpy(np.array(v, np.float32)),
                            stats=ab).payload.view(torch.uint8).numpy()
    return np.abs(_ordinal(codes(a)) - _ordinal(codes(b)))


def _jquant(x: np.ndarray):
    a, b = js2.compute_stats_jit(jnp.asarray(x))
    t = js2.quantize(jnp.asarray(x), stats=(a, b))
    u8 = np.asarray(jax.lax.bitcast_convert_type(t.payload, jnp.uint8))
    return t, torch.from_numpy(u8.copy()).view(torch.float8_e5m2), \
        torch.tensor([float(a), float(b)])


def _operand_shapes(layout):
    return {"nn": ((M, K), (K, N)), "nt": ((M, K), (N, K)),
            "tn": ((K, M), (K, N))}[layout]


@pytest.fixture
def fresh_counts():
    kernels.reset_counts()
    yield
    kernels.reset_counts()


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("layout,ga,gb,out_batch", [
    ("nn", 4, 4, None), ("nt", 4, 4, None), ("tn", 4, 4, None),
    ("nn", 8, 4, None),          # broadcast B: the becd,edf forward
    ("nn", 4, 8, None),          # broadcast A
    ("nt", 8, 4, None),          # its dA
    ("tn", 8, 8, 4),             # its dW: the broadcast groups summed
    ("tn", 2, 8, 4),             # broadcast A and a group sum together
])
def test_batched_plain_matches_reference(layout, ga, gb, out_batch, epilogue,
                                         fresh_counts):
    rng = np.random.default_rng(ga * 10 + gb)
    ash, bsh = _operand_shapes(layout)
    a = rng.standard_normal((ga,) + ash).astype(np.float32)
    b = (rng.standard_normal((gb,) + bsh) / np.sqrt(K)).astype(np.float32)
    ja, ta, aab = _jquant(a)
    jb, tb, bab = _jquant(b)
    kw = dict(layout=layout, out_batch=out_batch)
    raw = jref.s2fp8_matmul_batched_ref(ja.payload, ja.alpha, ja.beta,
                                        jb.payload, jb.alpha, jb.beta, **kw)
    out_ab = None
    if epilogue:
        oa, ob = js2.compute_stats_jit(raw)
        out_ab = torch.tensor([float(oa), float(ob)])
        want = np.asarray(jref.s2fp8_matmul_batched_ref(
            ja.payload, ja.alpha, ja.beta, jb.payload, jb.alpha, jb.beta,
            oa, ob, **kw))
    else:
        want = np.asarray(raw)
    got = s2fp8_matmul.qmatmul_batched(ta, aab, tb, bab, out_ab, **kw).numpy()
    go = out_batch or max(ga, gb)
    assert got.shape == want.shape == (go, M, N)
    if epilogue:
        steps = _grid_steps(want, got, out_ab)
        assert steps.max() <= 1 and np.mean(steps != 0) <= 1e-3
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert kernels.counts()["qmatmul_batched"] == {"launches": 0,
                                                   "plain_calls": 1}


def test_batched_dispatch_takes_strided_payloads_and_checks_shapes():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, K, M)).astype(np.float32)
    b = rng.standard_normal((4, K, N)).astype(np.float32)
    _, ta, aab = _jquant(a)
    _, tb, bab = _jquant(b)
    # the same values stored [G, M, K] and read back transposed: not
    # contiguous, so dispatch copies the 1-byte payload first
    ta_t = ta.view(torch.uint8).transpose(1, 2).view(torch.float8_e5m2)
    nn = dispatch.qmatmul_batched_nd(ta_t, aab, tb, bab, layout="nn")
    tn = dispatch.qmatmul_batched_nd(ta, aab, tb, bab, layout="tn")
    assert torch.equal(nn, tn)
    with pytest.raises(ValueError):              # 2-D payloads
        s2fp8_matmul.qmatmul_batched(ta[0], aab, tb[0], bab)
    with pytest.raises(ValueError):              # 3 does not divide 4
        s2fp8_matmul.qmatmul_batched(ta[:3], aab, tb, bab, layout="tn")
    with pytest.raises(ValueError):              # out_batch 3 of G = 4
        s2fp8_matmul.qmatmul_batched(ta, aab, tb, bab, layout="tn",
                                     out_batch=3)
    with pytest.raises(ValueError):              # contraction mismatch
        s2fp8_matmul.qmatmul_batched(ta, aab, tb, bab, layout="nn")


# the reference's planner table (tests/test_qdot_batched.py)
PLANNED = [
    # spec, a_shape, b_shape, (layout, batch, b_batch)
    ("ecd,edf->ecf", (4, 8, 16), (4, 16, 12), ("nn", 4, 4)),
    ("ecf,efd->ecd", (4, 8, 12), (4, 12, 16), ("nn", 4, 4)),
    ("becd,edf->becf", (2, 4, 8, 16), (4, 16, 12), ("nn", 8, 4)),
    ("bkgqd,bksd->bkgqs", (2, 3, 4, 8, 16), (2, 3, 10, 16), ("nt", 6, 6)),
    ("bkgqs,bksd->bkgqd", (2, 3, 4, 8, 10), (2, 3, 10, 16), ("nn", 6, 6)),
    ("bsd,df->bsf", (2, 6, 16), (16, 8), ("nn", 1, 1)),
    ("km,ksn->msn", (4, 8), (4, 6, 10), ("tn", 1, 1)),    # k first on both
]

REJECTED = [
    ("abc,abc->a", (2, 3, 4), (2, 3, 4)),          # multi-label contraction
    ("ab,bc->ca", (2, 3), (3, 4)),                 # transposed output
    ("abd,dc->bac", (2, 3, 4), (4, 5)),            # permuted free dims
    ("ad,bd->a", (2, 4), (3, 4)),                  # sum over free b
    ("dd,df->df", (4, 4), (4, 5)),                 # repeated label
    ("da,bd->ab", (4, 2), (3, 4)),                 # "tt": no kernel layout
    ("aeb,ecd->abcd", (2, 3, 4), (3, 5, 6)),       # shared label not batch
    ("ecd,def->ecf", (4, 8, 16), (16, 4, 12)),     # batch not leading on b
]


@pytest.mark.parametrize("spec,ash,bsh,want", PLANNED)
def test_planner_accepts_as_the_reference(spec, ash, bsh, want):
    plan = tbackend.plan_einsum(spec, ash, bsh)
    assert plan is not None, spec
    assert (plan.layout, plan.batch, plan.b_batch) == want, (spec, plan)
    assert tuple(plan) == tuple(jbackend.plan_einsum(spec, ash, bsh))
    # the plan is pure reshapes: the nodes' GEMM dispatch on the reshaped
    # payloads gives the einsum of their values (1e-5 * max: f32 sums in
    # another order) ...
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal(ash).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(bsh).astype(np.float32))
    be = tbackend.get_backend("plain")
    a2, b2 = a.reshape(plan.a2_shape), b.reshape(plan.b2_shape)
    qa = be.quantize(a2, stats=be.compute_stats(a2))
    qb = be.quantize(b2, stats=be.compute_stats(b2))
    raw = tqdot._qmm(be, qa, qb, plan.layout).reshape(plan.out_shape)
    exp = torch.einsum(spec, be.dequantize(qa).reshape(ash),
                       be.dequantize(qb).reshape(bsh))
    assert raw.shape == exp.shape
    assert (raw - exp).abs().max() <= 1e-5 * exp.abs().max()
    # ... and ``qdot_train`` with the plan (exact stats, no session) is that
    # product truncated on its own stats, bit for bit
    y = tqdot.qdot_train(a, b, plan=plan, backend="plain")
    assert torch.equal(y, be.truncate(raw, stats=be.compute_stats(raw)))


@pytest.mark.parametrize("spec,ash,bsh", REJECTED)
def test_planner_rejects_as_the_reference(spec, ash, bsh):
    assert tbackend.plan_einsum(spec, ash, bsh) is None, spec
    assert jbackend.plan_einsum(spec, ash, bsh) is None, spec
    # the payload policy falls back to the Fig. 4 chain, as the reference's
    # does: its result is the JAX payload policy's (the per-op forward
    # budget of tests/test_torch_fig4.py: at most 0.2% of the elements
    # beyond 1e-3 relative, none beyond 2% of max), and fp32 runs the
    # contraction
    rng = np.random.default_rng(len(spec))
    a = rng.standard_normal(ash).astype(np.float32)
    b = rng.standard_normal(bsh).astype(np.float32)
    y = make_policy("s2fp8", "plain", "payload").einsum(
        spec, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_policy("s2fp8", backend="ref",
                                 gemm_mode="payload").einsum(
        spec, jnp.asarray(a), jnp.asarray(b)))
    assert y.shape == want.shape
    d = np.abs(y - want)
    assert np.mean(d > 1e-3 * np.abs(want)) <= 2e-3
    assert d.max() <= 0.02 * np.abs(want).max()
    y = make_policy("fp32", "plain").einsum(spec, torch.from_numpy(a),
                                            torch.from_numpy(b))
    assert y.shape == want.shape


@pytest.mark.parametrize("a_shape,b_shape,dims,want", [
    ((3, 4, 8), (3, 8, 5), (((2,), (1,)), ((0,), (0,))), ("nn", 3)),
    ((3, 4, 8), (3, 5, 8), (((2,), (2,)), ((0,), (0,))), ("nt", 3)),
    ((3, 8, 4), (3, 8, 5), (((1,), (1,)), ((0,), (0,))), ("tn", 3)),
    ((4, 3, 8), (3, 8, 5), (((2,), (1,)), ((1,), (0,))), None),
    ((6, 8), (10, 8), (((1,), (1,)), ((), ())), ("nt", 1)),
])
def test_plan_qdot_general_batched_as_the_reference(a_shape, b_shape, dims,
                                                    want):
    plan = tbackend.plan_qdot_general(a_shape, b_shape, dims)
    jplan = jbackend.plan_qdot_general(a_shape, b_shape, dims)
    if want is None:
        assert plan is None and jplan is None
        return
    assert (plan.layout, plan.batch) == want
    assert tuple(plan) == tuple(jplan)
    # Policy.dot_general on the payload path against fp32 dot_general
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal(a_shape).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(b_shape).astype(np.float32))
    y = make_policy("s2fp8", "plain", "payload").dot_general(a, b, dims)
    want_y = np.asarray(jax.lax.dot_general(np.asarray(a), np.asarray(b),
                                            dims))
    assert y.shape == want_y.shape
    assert np.abs(y.numpy() - want_y).max() <= 0.1 * np.abs(want_y).max()
    y32 = make_policy("fp32", "plain").dot_general(a, b, dims)
    np.testing.assert_allclose(y32.numpy(), want_y, rtol=1e-5, atol=1e-5)
