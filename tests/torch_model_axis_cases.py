"""Multi-rank cases of ``tests/test_torch_model_axis.py``: one process per
rank on gloo (CPU), started by ``torch_mesh_cases.run_ranks`` with this
file as the script.  Each suite builds its meshes over the world's ranks
and rank 0 pickles its results for the test to check.  No JAX is
imported here: the params come from the test as numpy (the reference's
``init_params``), through ``convert.params_from_jax``.

    python tests/torch_model_axis_cases.py <suite> <rank> <world>
        <init file> <work dir>
"""
import os
import pickle
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
for _p in (HERE, SRC):
    if _p not in sys.path:
        sys.path.insert(0, _p)

ARCHS = ("minicpm_2b", "gemma3_1b")
CHAIN_MODES = ("fig4", "bf16", "fp8")
BATCH, SEQ, STEPS = 8, 32, 3
LR = 0.5


def policy(mode: str):
    """``"f32"``: the fp32 policy; ``"s2fp8"``: exact-stats s2fp8 on the
    payload GEMMs of the ``cuda_fused`` engine (its kernels' plain
    versions on the CPU); the chain's modes ``"fig4"`` (exact-stats s2fp8
    on the ``plain`` engine), ``"bf16"`` and ``"fp8"``."""
    from repro_torch.core.policy import make_policy
    return {"f32": lambda: make_policy("fp32"),
            "s2fp8": lambda: make_policy("s2fp8", "cuda_fused", "payload"),
            "fig4": lambda: make_policy("s2fp8", "plain", "fig4"),
            "bf16": lambda: make_policy("bf16"),
            "fp8": lambda: make_policy("fp8")}[mode]()


def reduced(arch: str, mode: str):
    """Reduced ``arch``; in f32 with f32 activations too, so that the only
    differences left are the order of f32 sums (bf16 activations round
    them onto a coarser grid)."""
    from repro_torch.configs import get_reduced_config
    cfg = get_reduced_config(arch)
    return cfg.replace(activation_dtype="float32") if mode == "f32" else cfg


def jax_params(arch: str, work: str):
    """The reference's params of reduced ``arch`` as numpy (saved by the
    test)."""
    with open(os.path.join(work, f"params_{arch}.pkl"), "rb") as f:
        return pickle.load(f)


def full_params(arch: str, work: str):
    """The reference's params of reduced ``arch`` as the port's tree."""
    from repro_torch.convert import params_from_jax
    return params_from_jax(jax_params(arch, work), device="cpu")


def batch(cfg, step: int, rows: int = BATCH, seq: int = SEQ):
    from repro_torch.data import synthetic
    chain = synthetic.markov_chain(0, cfg.vocab)
    gen = torch.Generator().manual_seed(1000 + step)
    return synthetic.lm_batch(chain, gen, rows, seq, "cpu")


SERVE_ROWS, SERVE_PROMPT, SERVE_STEPS, SERVE_LEN = 4, 40, 4, 64


def serve_inputs(cfg):
    """The seeded prompts [rows, prompt] and the fed tokens [steps, rows,
    1] of ``serve``."""
    gen = torch.Generator().manual_seed(7)
    prompts = torch.randint(0, cfg.vocab, (SERVE_ROWS, SERVE_PROMPT),
                            generator=gen)
    feed = torch.randint(0, cfg.vocab, (SERVE_STEPS, SERVE_ROWS, 1),
                         generator=gen)
    return prompts, feed


def save_inputs(arch: str, work: str) -> None:
    """``train``'s batches and ``serve``'s tokens of reduced ``arch`` as
    int32 numpy, for the reference's run (``torch_model_axis_ref.py``)."""
    cfg = reduced(arch, "f32")
    prompts, feed = serve_inputs(cfg)

    def np32(t):
        return t.numpy().astype(np.int32)
    out = {"batches": [{k: np32(v) for k, v in batch(cfg, s).items()}
                       for s in range(STEPS)],
           "prompts": np32(prompts), "feed": np32(feed),
           "max_len": SERVE_LEN}
    with open(os.path.join(work, f"inputs_{arch}.pkl"), "wb") as f:
        pickle.dump(out, f)


def host(tree):
    """A tree's tensor leaves in JAX's order, as numpy."""
    from repro_torch import convert
    return [x.detach().float().cpu().numpy() for x in
            convert.jax_leaves(tree)]


def train(arch: str, mode: str, mesh, work: str, steps: int = STEPS):
    """``steps`` SGD-momentum steps (clip 1.0, lr ``LR``) of reduced
    ``arch`` from the reference's params: (losses, the final params
    gathered whole on the host).  On a mesh the params are placed by
    ``param_pspecs`` (``convert.placed_from_jax``) and the step runs under
    ``TRAIN_RULES``; ``mesh=None`` is the meshless port."""
    from repro_torch import convert
    from repro_torch.launch import api
    from repro_torch.optim import optimizers, schedules
    from repro_torch.parallel import sharding as shd
    from repro_torch.training.trainer import make_train_step
    cfg = reduced(arch, mode)
    pol = policy(mode)
    params = full_params(arch, work)
    # SGD, whose updates follow the gradients' values (AdamW's first steps
    # follow their signs, which sums in another order flip where a
    # gradient is near 0)
    opt = optimizers.sgd_momentum(clip_norm=1.0)
    kw = {}
    if mesh is not None:
        where = api.placement(cfg, mesh, params)
        params = convert.placed_from_jax(jax_params(arch, work), mesh,
                                         specs=where.specs, device="cpu")
        kw = dict(mesh=mesh, placement=where)
    step = make_train_step(api.make_loss_fn(cfg), opt,
                           schedules.constant(LR), pol, **kw)
    ostate = opt.init(params)
    losses = []
    for s in range(steps):
        with _rules(mesh, shd.TRAIN_RULES):
            params, ostate, m = step(params, ostate, batch(cfg, s), s)
        losses.append(float(m["loss"]))
    if mesh is not None:
        params = shd.unplace_params(params, mesh, where.specs)
    return losses, host(params)


def _rules(mesh, rules):
    import contextlib
    from repro_torch.parallel import sharding as shd
    if mesh is None:
        return contextlib.nullcontext()
    return shd.use_rules(rules, dict(mesh.shape))


def serve(arch: str, mode: str, mesh, work: str):
    """Prefill ``SERVE_ROWS`` seeded prompts of ``SERVE_PROMPT`` tokens
    into dense caches of ``SERVE_LEN`` positions, then ``SERVE_STEPS``
    decode steps fed seeded tokens: every step's logits, whole, on the
    host.  On a mesh
    under ``DECODE_RULES``: params placed by ``param_pspecs``, the caches'
    positions split (``cache_pspecs``' ``S``), the MLP and vocab split,
    the logits' vocab slices gathered."""
    from repro_torch.core import collectives
    from repro_torch.launch import api
    from repro_torch.models import transformer as tlm
    from repro_torch.parallel import sharding as shd
    cfg = reduced(arch, mode)
    pol = policy(mode)
    params = full_params(arch, work)
    prompts, feed = serve_inputs(cfg)
    prompt = prompts.shape[1]
    caches = tlm.init_caches(cfg, SERVE_ROWS, SERVE_LEN, device="cpu",
                             dtype=torch.float32 if mode == "f32"
                             else torch.bfloat16)
    on = {}
    if mesh is not None:
        where = api.placement(cfg, mesh, params)
        params = shd.place_params(params, mesh, specs=where.specs)
        caches = shd.place_params(caches, mesh, specs=api.cache_pspecs(
            cfg, caches, dict(mesh.shape)))
        on = dict(placement=where)
    prefill = api.make_prefill_step(cfg, pol, **on)
    decode = api.make_decode_step(cfg, pol, **on)

    def whole(logits):
        if mesh is None:
            return logits.float().numpy()
        with collectives.bind(mesh):
            vs = tlm.vocab_split(cfg)
            if vs is not None:
                logits = collectives.gather_dim(logits, vs.axis,
                                                logits.dim() - 1)
        return logits.float().numpy()

    out = []
    with _rules(mesh, shd_rules("decode")), torch.no_grad():
        logits, caches = prefill(params, {"tokens": prompts}, caches)
        out.append(whole(logits))
        for i in range(SERVE_STEPS):
            logits, caches = decode(params, {"token": feed[i]}, caches,
                                    prompt + i)
            out.append(whole(logits))
    return out


def shd_rules(kind: str):
    from repro_torch.parallel import sharding as shd
    return shd.TRAIN_RULES if kind == "train" else shd.DECODE_RULES


def stats_case(mesh):
    """A tensor with zeros and a wide spread of magnitudes, split by
    columns over ``model``: per engine, every rank's whole-tensor (alpha,
    beta) (gathered) and the meshless value, and the same through a bank
    refresh."""
    from repro_torch.core import backend as nbackend
    from repro_torch.core import collectives, statsbank
    from repro_torch.parallel import sharding as shd
    rng = np.random.RandomState(3)
    x = (rng.standard_normal((64, 96))
         * np.exp2(rng.uniform(-20, 20, (64, 96)))).astype(np.float32)
    x[0, :7] = 0.0
    x = torch.from_numpy(x)
    out = {}
    with collectives.bind(mesh):
        sp = shd.Split("model", mesh.shape["model"], mesh.coords["model"])
        local = sp.take(x, 1).contiguous()
        for name in ("plain", "cuda", "cuda_fused"):
            be = nbackend.get_backend(name)
            ab = nbackend.split_stats(be, local, "e5m2", "model")
            out[name] = (collectives.all_gather(ab.reshape(1, 2),
                                                "model").numpy(),
                         be.compute_stats(x, fmt="e5m2").numpy())
        st = statsbank.init_site_state()
        new = statsbank.refresh_state(local, st, 0.0, split="model")
        whole = statsbank.refresh_state(x, st, 0.0)
        ab = torch.stack([new["alpha"], new["beta"]])
        out["refresh"] = (collectives.all_gather(ab.reshape(1, 2),
                                                 "model").numpy(),
                          torch.stack([whole["alpha"],
                                       whole["beta"]]).numpy())
    return out


def row_parallel_case(mesh):
    """A row-parallel payload dot (exact stats, ``cuda_fused``): the
    rank's columns of ``a`` and rows of ``b``, through ``qdot_train`` with
    a partial-sum ``TpSpec``; the whole dot; and the partial dots each
    truncated on their own, then summed (the epilogue fused into the
    partial GEMM)."""
    from repro_torch.core import collectives, qdot
    from repro_torch.core.collectives import TpSpec
    from repro_torch.parallel import sharding as shd
    rng = np.random.RandomState(5)
    a = torch.from_numpy(rng.standard_normal((32, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((128, 48)).astype(np.float32))
    with collectives.bind(mesh):
        sp = shd.Split("model", mesh.shape["model"], mesh.coords["model"])
        al, bl = sp.take(a, 1).contiguous(), sp.take(b, 0).contiguous()
        tp = TpSpec("model", "split", "split", "partial")
        y = qdot.qdot_train(al, bl, backend="cuda_fused", tp=tp)
        fused = collectives.all_reduce(
            qdot.qdot_train(al, bl, backend="cuda_fused"), "model")
    whole = qdot.qdot_train(a, b, backend="cuda_fused")
    return y.numpy(), whole.numpy(), fused.numpy()


def suite_world2(mesh_of, work):
    out = {}
    m12 = mesh_of("1x2")
    for arch in ARCHS:
        for mode in ("f32", "s2fp8"):
            out[f"train_1x2_{arch}_{mode}"] = train(arch, mode, m12, work)
            out[f"serve_1x2_{arch}_{mode}"] = serve(arch, mode, m12, work)
        for mode in CHAIN_MODES:
            out[f"train_1x2_{arch}_{mode}"] = train(arch, mode, m12, work)
    out["stats_1x2"] = stats_case(m12)
    out["row_parallel_1x2"] = row_parallel_case(m12)
    return out


def suite_world4(mesh_of, work):
    """2 x 2 and 1 x 4: the train runs, the stats, and the placement's
    round trip; at 1 x 4 the decode too (each rank 16 of the caches' 64
    positions)."""
    from repro_torch.parallel import sharding as shd
    out = {}
    for spec in ("2x2", "1x4"):
        mesh = mesh_of(spec)
        for arch in ARCHS:
            for mode in ("f32", "s2fp8"):
                out[f"train_{spec}_{arch}_{mode}"] = train(arch, mode, mesh,
                                                           work)
                if spec == "1x4":
                    out[f"serve_1x4_{arch}_{mode}"] = serve(arch, mode, mesh,
                                                            work)
            full = full_params(arch, work)
            specs = shd.param_specs(full, mesh.shape)
            back = shd.unplace_params(shd.place_params(full, mesh), mesh,
                                      specs)
            out[f"roundtrip_{spec}_{arch}"] = (host(back), host(full))
    out["stats_1x4"] = stats_case(mesh_of("1x4"))
    return out


if __name__ == "__main__":
    import torch_mesh_cases
    torch_mesh_cases._main(globals())
