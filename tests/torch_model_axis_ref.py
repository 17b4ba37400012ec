"""The reference's side of ``tests/test_torch_model_axis.py``: the JAX
package's steps compiled by GSPMD on a (1, 4) host mesh (``data`` 1 x
``model`` 4) and run, in a process of its own (the host device count must
be set before JAX starts).

Its jobs, on the inputs the test saved in the work dir (the reference's
params, the port's seeded batches, prompts and fed tokens):

* 3 SGD-momentum steps (clip 1.0, constant lr) of
  ``training.trainer.make_train_step`` under ``TRAIN_RULES``, params and
  optimizer state placed by ``api.param_pspecs``, the batch by
  ``batch_pspecs``: the losses and the final params, in f32 (f32
  activations) and in exact-stats s2fp8 (the ``ref`` engine's payload
  GEMMs);
* ``api.make_prefill_step`` then 4 ``make_decode_step`` calls under
  ``DECODE_RULES``, the caches placed by ``cache_pspecs`` (``S`` over
  ``model``): every step's logits;
* ``flops``: reduced minicpm_2b's train step as the dry run compiles it
  (AdamW, no remat, 2 x 64), its per-device FLOPs by
  ``roofline.hlo_cost``.

Each job is ``<arch>:<mode>:train``, ``<arch>:<mode>:serve`` or
``flops``; the test splits them over a few processes (each compile takes
10-80 s on the CPU):

    python tests/torch_model_axis_ref.py <work dir> <out file> <job>...
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

from repro.configs import get_reduced_config  # noqa: E402
from repro.core.policy import make_policy  # noqa: E402
from repro.launch import api  # noqa: E402
from repro.models import transformer as tlm  # noqa: E402
from repro.optim import optimizers, schedules  # noqa: E402
from repro.optim.optimizers import OptState  # noqa: E402
from repro.parallel import sharding as shd  # noqa: E402
from repro.training import trainer  # noqa: E402

STEPS, LR = 3, 0.5          # as tests/torch_model_axis_cases.py


def policy(mode):
    if mode == "f32":
        return make_policy("fp32")
    return make_policy("s2fp8", backend="ref", gemm_mode="payload")


def reduced(arch, mode):
    cfg = get_reduced_config(arch)
    return cfg.replace(activation_dtype="float32") if mode == "f32" else cfg


def main(work, out_file, jobs):
    mesh = jax.make_mesh((1, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))

    def sh(specs):
        return jax.tree_util.tree_map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda x: isinstance(x, P))

    out = {}
    for job in jobs:
        if job == "flops":
            out["flops"] = dryrun_flops(mesh, sizes, sh)
            continue
        arch, mode, kind = job.split(":")
        with open(os.path.join(work, f"params_{arch}.pkl"), "rb") as f:
            params0 = pickle.load(f)
        with open(os.path.join(work, f"inputs_{arch}.pkl"), "rb") as f:
            inputs = pickle.load(f)
        cfg, pol = reduced(arch, mode), policy(mode)
        pspecs = api.param_pspecs(cfg, params0, sizes)
        run = train if kind == "train" else serve
        out[(kind, arch, mode)] = run(cfg, pol, params0, pspecs, inputs,
                                      mesh, sizes, sh)
    with open(out_file, "wb") as f:
        pickle.dump(out, f)


def train(cfg, pol, params0, pspecs, inputs, mesh, sizes, sh):
    """(losses, final params' leaves) of the GSPMD train steps."""
    opt = optimizers.sgd_momentum(clip_norm=1.0)
    step_fn = trainer.make_train_step(api.make_loss_fn(cfg), opt,
                                      schedules.constant(LR), pol)
    batches = inputs["batches"]
    with mesh, shd.use_rules(shd.TRAIN_RULES, sizes):
        ospecs = sh(OptState(P(), pspecs, None))
        params = jax.device_put(params0, sh(pspecs))
        # placed on the mesh as the step's outputs are, so the second
        # step reuses the first one's compile
        ostate = jax.device_put(opt.init(params0), ospecs)
        step = jax.jit(step_fn, in_shardings=(
            sh(pspecs), ospecs, sh(api.batch_pspecs(batches[0], sizes)),
            None))
        losses = []
        for s, batch in enumerate(batches):
            params, ostate, m = step(params, ostate, batch, jnp.int32(s))
            losses.append(float(m["loss"]))
    return losses, [jax.device_get(x)
                    for x in jax.tree_util.tree_leaves(params)]


def serve(cfg, pol, params0, pspecs, inputs, mesh, sizes, sh):
    """Every step's logits of the GSPMD prefill and decode steps."""
    prompts, feed = inputs["prompts"], inputs["feed"]
    caches = tlm.init_caches(cfg, prompts.shape[0], inputs["max_len"],
                             dtype=jnp.float32
                             if cfg.activation_dtype == "float32"
                             else jnp.bfloat16)
    cspecs = api.cache_pspecs(cfg, caches, sizes)
    tok, one = {"tokens": prompts}, {"token": feed[0]}
    with mesh, shd.use_rules(shd.DECODE_RULES, sizes):
        params = jax.device_put(params0, sh(pspecs))
        caches = jax.device_put(caches, sh(cspecs))
        prefill = jax.jit(api.make_prefill_step(cfg, pol), in_shardings=(
            sh(pspecs), sh(api.batch_pspecs(tok, sizes)), sh(cspecs)))
        decode = jax.jit(api.make_decode_step(cfg, pol), in_shardings=(
            sh(pspecs), sh(api.batch_pspecs(one, sizes)), sh(cspecs),
            None))
        logits, caches = prefill(params, tok, caches)
        steps = [jax.device_get(logits)]
        for i in range(feed.shape[0]):
            logits, caches = decode(params, {"token": feed[i]}, caches,
                                    jnp.int32(prompts.shape[1] + i))
            steps.append(jax.device_get(logits))
    return steps


def dryrun_flops(mesh, sizes, sh):
    """Reduced minicpm_2b's train step lowered as the dry run lowers it
    (``api.make_train_step``: AdamW), its per-device FLOPs."""
    from repro.roofline import hlo_cost
    cfg = get_reduced_config("minicpm_2b").replace(remat=False)
    pol = make_policy("s2fp8", backend="ref", gemm_mode="payload")
    pstruct = api.param_struct(cfg)
    bstruct = {k: jax.ShapeDtypeStruct((2, 64), jnp.int32)
               for k in ("tokens", "labels")}
    with mesh, shd.use_rules(shd.TRAIN_RULES, sizes):
        step_fn, opt = api.make_train_step(cfg, pol)
        ostruct = jax.eval_shape(opt.init, pstruct)
        ospecs = OptState(P(), api.param_pspecs(cfg, ostruct.m, sizes),
                          api.param_pspecs(cfg, ostruct.v, sizes))
        compiled = jax.jit(step_fn, in_shardings=(
            sh(api.param_pspecs(cfg, pstruct, sizes)), sh(ospecs),
            sh(api.batch_pspecs(bstruct, sizes)), None)).lower(
                pstruct, ostruct, bstruct, jnp.int32(0)).compile()
    return hlo_cost.cost_of(compiled.as_text()).flops


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3:])
