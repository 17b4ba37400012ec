"""The order-exact toy of ``tests/mesh_toy.py`` for the port: the same
numpy seeds and arrays, trained by the port's ``make_train_step``.

Every cross-shard reduction of this toy is exact in f32 (one-hot rows,
constant-magnitude weights and cotangents, every StatsBank site in the
degenerate stats branch, policy ``s2fp8_e4m3``; see ``mesh_toy.py``), so
a data-parallel or FSDP step on any number of ranks reproduces the
1-rank and the meshless step bit for bit.  ``w`` [8, 16] f32 is
gather-eligible on any fsdp axis dividing 8 and payload-eligible under
``fsdp_q`` (its only consumer is the ``Policy.dot`` GEMM B slot).
"""
import numpy as np
import torch

B = 8          # global batch == K so x's one-hot rows are a permutation
K = 8
N_FEAT = 16
LR = 1e-3
REFRESH_EVERY = 64


def make_params(device="cpu"):
    w = np.zeros((K, N_FEAT), np.float32)
    rng = np.random.RandomState(0)
    for k in range(K):
        w[k, rng.randint(N_FEAT)] = rng.choice([-1.0, 1.0]) * 0.125
    return {"w": torch.from_numpy(w).to(device)}


def make_batch(step: int, device="cpu"):
    rng = np.random.RandomState(1000 + step)
    x = np.zeros((B, K), np.float32)
    for b in range(B):
        x[b, (b + step) % K] = rng.choice([-1.0, 1.0])
    t = rng.choice([-1.0, 1.0], size=(B, N_FEAT)).astype(np.float32)
    return {"x": torch.from_numpy(x).to(device),
            "t": torch.from_numpy(t).to(device)}


def loss_fn(params, batch, pol):
    """Batch-mean linear loss: one ``Policy.dot``, one GEMM bank node."""
    y = pol.dot(batch["x"], params["w"])
    return torch.mean(torch.sum(y * batch["t"], dim=-1)), {}


def setup(mesh=None, grad_sync_mode="f32", telemetry=False, guard=None,
          param_sharding="replicated", device="cpu", backend=None,
          clip_axis_name=None, grad_sync_min_size=1 << 16):
    """(step_fn, params, opt_state, bank, stats_cfg) of the toy.  Under
    ``fsdp`` / ``fsdp_q`` the params and optimizer state come back as this
    rank's shards (``sharding.shard_tree``); the bank is built from the
    full params first."""
    from repro_torch.core import statsbank
    from repro_torch.core.policy import make_policy
    from repro_torch.optim import optimizers, schedules
    from repro_torch.parallel import sharding
    from repro_torch.training.trainer import make_train_step

    pol = make_policy("s2fp8_e4m3", backend, gemm_mode="payload")
    params = make_params(device)
    opt = optimizers.adamw(clip_axis_name=clip_axis_name)
    cfg = statsbank.StatsConfig(refresh_every=REFRESH_EVERY,
                                telemetry=telemetry)
    bank = statsbank.init_bank(loss_fn, params, make_batch(0, device), pol,
                               cfg)
    step_fn = make_train_step(loss_fn, opt, schedules.constant(LR), pol,
                              stats=cfg, mesh=mesh,
                              grad_sync_mode=grad_sync_mode, guard=guard,
                              param_sharding=param_sharding,
                              grad_sync_min_size=grad_sync_min_size)
    if mesh is not None and param_sharding != "replicated":
        params = sharding.shard_tree(params, mesh, param_sharding)
    opt_state = opt.init(params)
    sharding.mark_opt_state(opt_state, params)
    return step_fn, params, opt_state, bank, cfg


def run(step_fn, params, opt_state, bank, n_steps: int, start: int = 0,
        device="cpu"):
    metrics = None
    for s in range(start, n_steps):
        params, opt_state, bank, metrics = step_fn(
            params, opt_state, bank, make_batch(s, device), s)
    return params, opt_state, bank, metrics
