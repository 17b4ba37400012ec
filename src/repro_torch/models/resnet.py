"""CIFAR ResNets (He et al. 2016, pre-activation), the paper's §4.2 models
(port of ``repro.models.resnet``).

ResNet-20/32/44/56 (the 6n+2 basic-block family).  Every conv runs through
``Policy.conv`` (on the payload path the im2col lowering onto the payload
GEMM) and the head through ``Policy.dot``; batch norm runs in f32 with
running statistics carried in a separate state tree, which
``resnet_apply`` returns beside the logits, detached.  The params keep the
reference's tree: HWIO kernels ``stem`` and the blocks' ``conv1``,
``conv2`` and ``proj``, ``blocks`` a list, ``bns`` an empty list, so
``convert.params_from_jax`` carries ``init_resnet``'s (params, state)
unchanged.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import statsbank
from repro_torch.core.policy import Policy


def init_bn(c: int, device=None) -> Tuple[Dict, Dict]:
    """(params {scale, bias}, state {mean, var}) of a c-channel batch
    norm."""
    def full(v):
        return torch.full((c,), v, dtype=torch.float32, device=device)
    return ({"scale": full(1.0), "bias": full(0.0)},
            {"mean": full(0.0), "var": full(1.0)})


def batch_norm(p, st, x: torch.Tensor, train: bool, momentum: float = 0.9):
    """In f32 over (N, H, W): in training the batch's mean and population
    variance, the running state moved by ``momentum`` (detached); in eval
    the running state.  Eps 1e-5.  Returns (y in x's dtype, state)."""
    xf = x.float()
    if train:
        mean = xf.mean(dim=(0, 1, 2))
        c = xf - mean
        var = (c * c).mean(dim=(0, 1, 2))
        new_st = {"mean": (momentum * st["mean"]
                           + (1 - momentum) * mean).detach(),
                  "var": (momentum * st["var"]
                          + (1 - momentum) * var).detach()}
    else:
        mean, var, new_st = st["mean"], st["var"], st
    y = (xf - mean) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    return y.to(x.dtype), new_st


def init_resnet(depth: int = 20, n_classes: int = 10, width: int = 16,
                seed: int = 0, device=None):
    """(params, state) from a seeded ``torch.Generator``: He-normal conv
    kernels (std sqrt(2 / (k * k * cin))), the head N(0, 1/cin); the
    reference's leaves (JAX draws other numbers)."""
    if (depth - 2) % 6:
        raise ValueError("CIFAR ResNet depth must be 6n+2")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = (depth - 2) // 6

    def conv_init(k, cin, cout):
        return torch.randn((k, k, cin, cout), generator=gen,
                           device=dev) * math.sqrt(2.0 / (k * k * cin))

    params: Dict = {"stem": conv_init(3, 3, width), "blocks": [], "bns": []}
    state: Dict = {"bns": []}
    params["stem_bn"], state["stem_bn"] = init_bn(width, dev)
    cin = width
    for stage, cout in enumerate([width, 2 * width, 4 * width]):
        for blk in range(n):
            stride = 2 if (stage > 0 and blk == 0) else 1
            bp1, bs1 = init_bn(cin, dev)
            bp2, bs2 = init_bn(cout, dev)
            block = {"bn1": bp1, "conv1": conv_init(3, cin, cout),
                     "bn2": bp2, "conv2": conv_init(3, cout, cout)}
            if stride != 1 or cin != cout:
                block["proj"] = conv_init(1, cin, cout)
            params["blocks"].append(block)
            state["bns"].append({"bn1": bs1, "bn2": bs2})
            cin = cout
    params["final_bn"], state["final_bn"] = init_bn(cin, dev)
    params["fc"] = torch.randn((cin, n_classes), generator=gen,
                               device=dev) / math.sqrt(cin)
    return params, state


def resnet_apply(params, state, x: torch.Tensor, pol: Policy, train: bool):
    """x: [B, 32, 32, 3] -> (logits [B, n_classes], new state).  The
    first block of stages 2 and 3 downsamples (stride 2, from the block's
    position); conv sites sit under the StatsBank scopes "stem",
    "block{i}" and "head"."""
    new_state: Dict = {"bns": []}
    with statsbank.scope("stem"):
        h = pol.conv(x, params["stem"])
    h, new_state["stem_bn"] = batch_norm(params["stem_bn"], state["stem_bn"],
                                         h, train)
    h = torch.relu(h)
    n = len(params["blocks"]) // 3
    for i, (block, bst) in enumerate(zip(params["blocks"], state["bns"])):
        stride = (2, 2) if i in (n, 2 * n) else (1, 1)
        y, bs1 = batch_norm(block["bn1"], bst["bn1"], h, train)
        y = torch.relu(y)
        shortcut = h
        with statsbank.scope(f"block{i}"):
            if "proj" in block:
                shortcut = pol.conv(y, block["proj"], stride=stride)
            y = pol.conv(y, block["conv1"], stride=stride)
            y, bs2 = batch_norm(block["bn2"], bst["bn2"], y, train)
            y = torch.relu(y)
            y = pol.conv(y, block["conv2"])
        h = shortcut + y
        new_state["bns"].append({"bn1": bs1, "bn2": bs2})
    h, new_state["final_bn"] = batch_norm(params["final_bn"],
                                          state["final_bn"], h, train)
    h = torch.relu(h).mean(dim=(1, 2))
    with statsbank.scope("head"):
        return pol.dot(h, params["fc"]), new_state


def loss_fn(params, state, batch, pol: Policy, train: bool = True):
    """Softmax cross entropy -> (nll, ({"nll", "acc"}, new state))."""
    logits, new_state = resnet_apply(params, state, batch["images"], pol,
                                     train)
    logits = logits.float()
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(labels, logits.shape[-1]).float()
    nll = -(onehot * logp).sum(dim=-1).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll, ({"nll": nll, "acc": acc}, new_state)
