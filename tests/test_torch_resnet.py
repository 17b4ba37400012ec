"""The port's ResNet path (``Policy.conv``, ``repro_torch.models.resnet``)
against the JAX package's, on the CPU.

``Policy.conv`` per call against the JAX policy's conv (stride 1 and 2,
1x1 and 3x3, the stem's K = 27) in every mode, with the im2col patches of
the payload path held bit for bit; ``resnet_apply`` in train and eval
mode with the new batch-norm state; ``loss_fn`` and its gradients in every
mode; 8 steps of ``examples/train_resnet_cifar.py``'s recipe (SGD momentum
0.9, weight decay 1e-4, step decay) as a loss curve; the CIFAR batch
generator, ``step_decay`` and the params carry.

Both sides start from JAX ``init_resnet`` params carried over by
``convert.params_from_jax`` and from JAX ``cifar_batch`` batches as numpy
arrays.  The JAX side is the ``ref`` engine (``gemm_mode`` named for
s2fp8), the port the ``plain`` engine with the same ``gemm_mode``.
ResNet activations are f32.  Tolerances are stated beside each assert.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.core import qdot as jqdot
from repro.core.policy import make_policy as jax_policy
from repro.data import synthetic as jsyn
from repro.models import resnet as jresnet
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import (conv_out_shape, conv_pads, im2col,
                                     make_policy)
from repro_torch.data import synthetic
from repro_torch.models import resnet
from repro_torch.optim import optimizers, schedules
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.training.trainer import make_train_step

jax.config.update("jax_platform_name", "cpu")

# (mode, gemm_mode) of the per-call and whole-model cases
MODES = [("fp32", None), ("bf16", None), ("fp8", None), ("fp8_ls", None),
         ("s2fp8", "payload"), ("s2fp8", "fig4")]
# per-call flip budgets of tests/test_torch_policy_modes.py: an element
# agrees within 1e-3 relative or is a flipped code; forward at most 0.2%
# flipped and none further than 2% of max|value|, gradients 2% and 10%
FWD = (2e-3, 0.02)
GRAD = (2e-2, 0.1)
# the conv's forward takes 10% flipped: in fig4 the output's stats come
# from the raw conv output, whose f32 sums the two packages order
# differently, and stats an ulp apart move the whole grid (measured: 6% of
# a stride-2 conv's 512 outputs one code apart, while the JAX truncation
# of the port's raw output equals the port's output bit for bit)
FWD_CONV = (0.1, 0.02)
# (x shape NHWC, kernel HWIO, stride): the stem (K = 27), a stage's 3x3,
# the first 3x3 of stage 2 (stride 2, SAME pads (0, 1)) and its 1x1 proj
CONVS = [((2, 8, 8, 3), (3, 3, 3, 8), (1, 1)),
         ((2, 8, 8, 8), (3, 3, 8, 8), (1, 1)),
         ((2, 8, 8, 8), (3, 3, 8, 16), (2, 2)),
         ((2, 8, 8, 8), (1, 1, 8, 16), (2, 2))]
# every mode on the stem and the stride-2 3x3; fp32 and s2fp8 payload on
# the stride-1 3x3 and the 1x1 projection
CONV_CASES = ([(c, m) for c in (CONVS[0], CONVS[2]) for m in MODES]
              + [(c, m) for c in (CONVS[1], CONVS[3])
                 for m in (MODES[0], MODES[4])])


def _pols(mode, gemm_mode):
    kw = {} if gemm_mode is None else {"gemm_mode": gemm_mode}
    return (jax_policy(mode, backend="ref", **kw),
            make_policy(mode, "plain", **kw))


def _flip_close(got, want, budget, step):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got - want)
    flipped = np.mean(d > 1e-3 * np.abs(want))
    worst = d.max() / max(np.abs(want).max(), 1e-30)
    assert flipped <= budget and worst <= step, (flipped, worst)


def _conv_inputs(xs, ks, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(xs).astype(np.float32),
            (rng.standard_normal(ks) * 0.3).astype(np.float32),
            rng.standard_normal(conv_out_shape(xs, ks, (1, 1), "SAME")
                                ).astype(np.float32))


@pytest.mark.parametrize("xs,ks,stride", CONVS)
def test_im2col_patches_equal_jax_bit_for_bit(xs, ks, stride):
    """The payload path's patches: the port's ``im2col`` equals the tensor
    the JAX policy hands ``qdot_train`` (captured), bit for bit, and the
    kernel flattens to [KH*KW*C, F] against it on both sides."""
    x, k, _ = _conv_inputs(xs, ks, 0)
    seen = []
    orig = jqdot.qdot_train

    def capture(a, b, **kw):
        seen.append((a, b))
        return orig(a, b, **kw)

    def conv(x_, k_):
        jax_policy("s2fp8", backend="ref", gemm_mode="payload").conv(
            x_, k_, stride=stride)
        (a, b), = seen
        return a, b              # the operands, out of the traced program

    jqdot.qdot_train = capture
    try:
        jp, jk = (np.asarray(t) for t in jax.jit(conv)(jnp.asarray(x),
                                                       jnp.asarray(k)))
    finally:
        jqdot.qdot_train = orig
    pads = conv_pads(xs[1:3], ks[:2], stride, "SAME")
    tp = im2col(torch.from_numpy(x), ks[0], ks[1], stride, pads)
    assert tp.shape[-1] == ks[0] * ks[1] * ks[2]
    assert np.array_equal(tp.numpy(), jp)
    assert np.array_equal(
        torch.from_numpy(k).reshape(-1, ks[3]).numpy(), jk)


def test_same_padding_and_output_shapes_follow_lax():
    """"SAME" pads as ``lax.padtype_to_pads``: asymmetric at stride 2 (32
    -> 16 with a 3x3 kernel pads (0, 1)), none for the 1x1 projection;
    output shapes as ``lax.conv_general_dilated`` gives them, "VALID" and
    explicit pads included."""
    assert conv_pads((32, 32), (3, 3), (2, 2), "SAME") == ((0, 1), (0, 1))
    assert conv_pads((32, 32), (3, 3), (1, 1), "SAME") == ((1, 1), (1, 1))
    assert conv_pads((32, 32), (1, 1), (2, 2), "SAME") == ((0, 0), (0, 0))
    for xs, ks, st, pad in [((1, 32, 32, 3), (3, 3, 3, 4), (2, 2), "SAME"),
                            ((1, 9, 7, 2), (3, 3, 2, 4), (2, 2), "SAME"),
                            ((1, 9, 7, 2), (3, 2, 2, 4), (1, 2), "VALID"),
                            ((1, 9, 7, 2), (3, 3, 2, 4), (2, 1),
                             ((1, 0), (2, 1)))]:
        want = jax.eval_shape(lambda a, b: jax.lax.conv_general_dilated(
            a, b, st, pad, dimension_numbers=("NHWC", "HWIO", "NHWC")),
            jax.ShapeDtypeStruct(xs, jnp.float32),
            jax.ShapeDtypeStruct(ks, jnp.float32)).shape
        assert conv_out_shape(xs, ks, st, pad) == tuple(want)
        if isinstance(pad, str):
            assert conv_pads(xs[1:3], ks[:2], st, pad) == tuple(
                tuple(p) for p in jax.lax.padtype_to_pads(
                    xs[1:3], ks[:2], st, pad))


@pytest.mark.parametrize("conv,modes", CONV_CASES)
def test_conv_matches_jax(conv, modes):
    """``Policy.conv`` and its gradients (x and kernel) against the JAX
    policy's on the same inputs.  fp32 and bf16 round no code: within
    1e-5 * max|JAX| (f32 sums in another order; bf16 operands are upcast
    exactly, products exact in f32).  The truncating modes take the
    per-call flip budgets above.  bf16 holds the forward only: the JAX
    package's bf16 conv cannot be differentiated (the transpose of its
    ``lax.conv_general_dilated`` with ``preferred_element_type`` f32 gets
    bf16 and f32 operands and raises)."""
    (xs, ks, stride), (mode, gemm_mode) = conv, modes
    x, k, _ = _conv_inputs(xs, ks, 1)
    jpol, tpol = _pols(mode, gemm_mode)
    tx = torch.from_numpy(x).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    ty = tpol.conv(tx, tk, stride=stride)
    assert ty.dtype == torch.float32
    g = np.random.default_rng(2).standard_normal(ty.shape).astype(np.float32)

    def jrun(a, b, gy):
        y, vjp = jax.vjp(lambda a_, b_: jpol.conv(a_, b_, stride=stride),
                         a, b)
        return (y,) if mode == "bf16" else (y,) + vjp(gy)

    jout = jax.jit(jrun)(jnp.asarray(x), jnp.asarray(k), jnp.asarray(g))
    jy = jout[0]
    exact = mode in ("fp32", "bf16")

    def close(got, want, budget):
        want = np.asarray(want)
        if exact:
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        else:
            _flip_close(got, want, *budget)

    close(ty.detach().numpy(), jy, FWD_CONV)
    if mode == "bf16":
        return
    jgx, jgk = jout[1:]
    tgx, tgk = torch.autograd.grad(ty, (tx, tk), torch.from_numpy(g))
    close(tgx.numpy(), jgx, GRAD)
    close(tgk.numpy(), jgk, GRAD)


@pytest.fixture(scope="module")
def small():
    """ResNet-8 (one block a stage) of width 8 and a batch of 4."""
    # jitted: eager JAX compiles each random op of the init on its own
    params, state = jax.jit(lambda key: jresnet.init_resnet(
        key, depth=8, width=8))(jax.random.PRNGKey(0))
    batch = {k: np.asarray(v) for k, v in jax.jit(
        lambda s: jsyn.cifar_batch(0, s, 4))(0).items()}
    return {"jp": params, "js": state, "np_p": jax.device_get(params),
            "np_s": jax.device_get(state), "batch": batch}


def _tbatch(batch):
    return {"images": torch.from_numpy(batch["images"]),
            "labels": torch.from_numpy(batch["labels"]).long()}


@pytest.mark.parametrize("train", [True, False])
def test_resnet_apply_matches_jax(small, train):
    """fp32 logits within 1e-4 * max|JAX| (measured 1.2e-6); in training the
    new running mean and variance within 1e-5 * max|JAX| (measured 2.9e-6),
    detached,
    and in eval the state passes through unchanged."""
    pol_j, pol_t = _pols("fp32", None)
    jl, jst = jax.jit(lambda p, s, x: jresnet.resnet_apply(
        p, s, x, pol_j, train))(small["jp"], small["js"],
                                small["batch"]["images"])
    params = params_from_jax(small["np_p"], device="cpu")
    state = params_from_jax(small["np_s"], device="cpu")
    tl, tst = resnet.resnet_apply(params, state,
                                  _tbatch(small["batch"])["images"], pol_t,
                                  train)
    jl = np.asarray(jl)
    assert tuple(tl.shape) == (4, 10)
    assert np.abs(tl.detach().numpy() - jl).max() <= 1e-4 * np.abs(jl).max()
    jleaves = jax.tree_util.tree_leaves(jst)
    tleaves = tree_leaves(tst)
    assert len(jleaves) == len(tleaves)
    for w, g in zip(jleaves, tleaves):
        assert not g.requires_grad
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    if not train:
        assert all(g is w for g, w in zip(tleaves, tree_leaves(state)))


@pytest.mark.parametrize("mode,gemm_mode", [m for m in MODES
                                            if m[0] != "bf16"])
def test_loss_and_gradients_match_jax(small, mode, gemm_mode):
    """``loss_fn`` and its gradients on ResNet-8 in each mode the JAX
    package can differentiate.  fp32: the loss within 1e-4 relative
    (measured equal) and each gradient leaf within 2e-2 relative (L2;
    measured 6e-6 here): a pre-activation within 1e-6 of zero can land on
    the other side of the ReLU in one package's f32 rounding, which moves
    one element of the batch norms' backward (seen on ResNet-20 at batch
    8: one such element at 8e-7 moved the stem's gradient by 0.5% and a
    batch-norm bias's by 1.1%, while float64 runs of each package agree
    with their own f32 run to 1e-6), and the deepest leaves, the head and
    the final batch norm, stay within 1e-4.  The truncating modes: the
    loss within 0.02 (measured at most 8e-4) and the concatenated
    gradients' cosine at least 0.9 (measured at least 0.991; raw e5m2 and
    the two sides' own stats put independent noise on every cotangent;
    per-call parity is held above)."""
    pol_j, pol_t = _pols(mode, gemm_mode)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jresnet.loss_fn(p, small["js"], small["batch"], pol_j),
        has_aux=True))(small["jp"])
    params = params_from_jax(small["np_p"], device="cpu")
    state = params_from_jax(small["np_s"], device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tl, (metrics, _) = resnet.loss_fn(params, state, _tbatch(small["batch"]),
                                      pol_t)
    tg = [g.numpy() for g in torch.autograd.grad(tl, leaves)]
    jg = [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)]
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(small["jp"])[0]]
    assert [g.shape for g in tg] == [g.shape for g in jg]
    assert 0.0 <= float(metrics["acc"]) <= 1.0
    if mode == "fp32":
        assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
        for path, got, want in zip(paths, tg, jg):
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            lim = 1e-4 if path.startswith(("['fc']", "['final_bn']")) \
                else 2e-2
            assert rel <= lim, (path, rel)
        return
    assert abs(float(tl) - float(jl)) <= 0.02, (float(tl), float(jl))
    cat_t = np.concatenate([g.ravel() for g in tg])
    cat_j = np.concatenate([g.ravel() for g in jg])
    cos = cat_t @ cat_j / (np.linalg.norm(cat_t) * np.linalg.norm(cat_j))
    assert cos >= 0.9, cos


@pytest.mark.parametrize("mode,gemm_mode", [("s2fp8", "payload")])
def test_recipe_loss_curve_matches_jax(mode, gemm_mode):
    """8 steps of ``examples/train_resnet_cifar.py``'s recipe on ResNet-20
    (SGD momentum 0.9, weight decay 1e-4, step decay from 0.05 at steps 4
    and 6, batch 4 of the CIFAR blobs) from the same params and batches;
    the port trains through ``make_train_step`` with the batch-norm state
    carried beside it.  Per-step |port - JAX| loss at most 0.1 (measured
    at most 0.035: code flips move the gradients by several percent, and
    SGD with momentum carries them into the next steps), every loss
    finite."""
    steps = 8
    pol_j, pol_t = _pols(mode, gemm_mode)
    jp, js = jax.jit(lambda key: jresnet.init_resnet(key, 20))(
        jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jp), device="cpu")
    state = {"bn": params_from_jax(jax.device_get(js), device="cpu")}
    cifar = jax.jit(lambda s: jsyn.cifar_batch(0, s, 4))
    batches = [{k: np.asarray(v) for k, v in cifar(s).items()}
               for s in range(steps)]
    bounds = [int(steps * 0.6), int(steps * 0.85)]
    jo = jopt.sgd_momentum(momentum=0.9, weight_decay=1e-4)
    jsch = jsched.step_decay(0.05, bounds)

    @jax.jit
    def jstep(p, bn, o, b, s):
        (loss, (_, new_bn)), g = jax.value_and_grad(
            lambda p_: jresnet.loss_fn(p_, bn, b, pol_j), has_aux=True)(p)
        p, o = jo.update(g, o, p, jsch(s))
        return p, new_bn, o, loss

    jo_state = jo.init(jp)
    jlosses = []
    for s, b in enumerate(batches):
        jp, js, jo_state, loss = jstep(jp, js, jo_state, b, jnp.int32(s))
        jlosses.append(float(loss))

    def loss_fn(p, b, pol):
        loss, (metrics, new_bn) = resnet.loss_fn(p, state["bn"], b, pol)
        state["new"] = new_bn
        return loss, metrics

    opt = optimizers.sgd_momentum(momentum=0.9, weight_decay=1e-4)
    step = make_train_step(loss_fn, opt, schedules.step_decay(0.05, bounds),
                           pol_t)
    opt_state = opt.init(params)
    tlosses = []
    for s, b in enumerate(batches):
        params, opt_state, m = step(params, opt_state, _tbatch(b), s)
        state["bn"] = state["new"]
        tlosses.append(float(m["loss"]))
    assert np.isfinite(tlosses).all()
    d = np.abs(np.array(tlosses) - np.array(jlosses))
    assert d.max() <= 0.1, (tlosses, jlosses)


def test_cifar_batch_shapes_and_ranges():
    """Class-conditional blobs: images [B, 32, 32, 3] f32 = the label's
    fixed center (sd 0.8) + noise (sd 0.6), labels in [0, 10); the same
    seed gives the same centers."""
    centers = synthetic.cifar_centers(0)
    assert tuple(centers.shape) == (10, 32, 32, 3)
    assert torch.equal(centers, synthetic.cifar_centers(0))
    assert 0.7 < float(centers.std()) < 0.9
    b = synthetic.cifar_batch(centers, torch.Generator().manual_seed(0), 64,
                              device="cpu")
    assert tuple(b["images"].shape) == (64, 32, 32, 3)
    assert b["images"].dtype == torch.float32
    assert b["labels"].dtype == torch.int64
    assert 0 <= int(b["labels"].min()) and int(b["labels"].max()) < 10
    noise = b["images"] - centers[b["labels"]]
    assert 0.55 < float(noise.std()) < 0.65


def test_step_decay_matches_jax():
    """The f32 learning rate of every step equals JAX's."""
    j, t = jsched.step_decay(0.05, [48, 68]), schedules.step_decay(
        0.05, [48, 68])
    for s in range(100):
        assert np.float32(t(s)) == np.float32(j(s)), s


def test_params_from_jax_carries_the_resnet_tree(small):
    """(params, state) carry with JAX's leaves and values: HWIO kernels,
    ``blocks`` a list with ``proj`` where a block downsamples, ``bns`` an
    empty list, the batch-norm running state; the port's ``init_resnet``
    makes the same tree."""
    params = params_from_jax(small["np_p"], device="cpu")
    state = params_from_jax(small["np_s"], device="cpu")
    for tree, jt in ((params, small["np_p"]), (state, small["np_s"])):
        jl = jax.tree_util.tree_leaves(jt)
        tl = tree_leaves(tree)
        assert len(jl) == len(tl)
        assert all(np.array_equal(g.numpy(), np.asarray(w))
                   for g, w in zip(tl, jl))
    assert params["bns"] == [] and len(params["blocks"]) == 3
    assert tuple(params["blocks"][1]["proj"].shape) == (1, 1, 8, 16)
    own_p, own_s = resnet.init_resnet(depth=8, width=8, device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)
    assert shapes(own_p) == shapes(params)
    assert shapes(own_s) == shapes(state)
