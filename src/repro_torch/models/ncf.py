"""Neural Collaborative Filtering (He et al. 2017), the paper's §4.4 model
(port of ``repro.models.ncf``).

NeuMF: a GMF branch (the elementwise product of user and item embeddings)
and an MLP branch (the concatenated embeddings through a tower), fused
into one logit by a GEMM with N = 1.  The MLP's and the output's GEMMs run
through the policy, and in the truncating modes (s2fp8, s2fp8_e4m3, fp8,
fp8_ls) each embedding table is truncated whole before its lookup, as the
reference does ("matrix multiplications and look-ups from the embeddings
in S2FP8").
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.core.policy import TRUNCATING_MODES, Policy


def init_ncf(n_users: int, n_items: int, factors: int = 8,
             mlp_layers=(64, 32, 16, 8), seed: int = 0, device=None) -> Dict:
    """The reference's leaves and per-leaf std from a seeded
    ``torch.Generator`` (JAX draws other numbers)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    mlp_embed = mlp_layers[0] // 2
    p = {"gmf_user": normal((n_users, factors), 0.01),
         "gmf_item": normal((n_items, factors), 0.01),
         "mlp_user": normal((n_users, mlp_embed), 0.01),
         "mlp_item": normal((n_items, mlp_embed), 0.01),
         "mlp": [],
         "out": normal((factors + mlp_layers[-1], 1), 0.1)}
    d_in = mlp_layers[0]
    for d_out in mlp_layers[1:]:
        p["mlp"].append({"w": normal((d_in, d_out), 1.0 / math.sqrt(d_in)),
                         "b": torch.zeros((d_out,), device=dev)})
        d_in = d_out
    return p


def ncf_logits(p, users: torch.Tensor, items: torch.Tensor, pol: Policy
               ) -> torch.Tensor:
    """[B] logits of the (user, item) pairs."""
    def lookup(table, idx):
        if pol.mode in TRUNCATING_MODES:
            table = pol.truncate(table)
        return table[idx.long()]

    gmf = lookup(p["gmf_user"], users) * lookup(p["gmf_item"], items)
    h = torch.cat([lookup(p["mlp_user"], users),
                   lookup(p["mlp_item"], items)], dim=-1)
    for layer in p["mlp"]:
        h = torch.relu(pol.dot(h, layer["w"]) + layer["b"])
    fused = torch.cat([gmf, h], dim=-1)
    return pol.dot(fused, p["out"])[..., 0]


def loss_fn(p, batch, pol: Policy):
    """Binary cross entropy on implicit feedback (labels in {0, 1}), in the
    reference's stable form -> (loss, {"nll": loss})."""
    logits = ncf_logits(p, batch["users"], batch["items"], pol)
    labels = batch["labels"].float()
    loss = (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()
    return loss, {"nll": loss}


def hit_ratio(p, users, pos_items, neg_items, pol: Policy, k: int = 10
              ) -> torch.Tensor:
    """HR@k: the share of users whose positive item ranks among the top k
    of itself and its negatives (the paper's protocol: 99 negatives)."""
    all_items = torch.cat([pos_items[:, None], neg_items], dim=1)
    b, n = all_items.shape
    u = users[:, None].expand(b, n)
    scores = ncf_logits(p, u.reshape(-1), all_items.reshape(-1),
                        pol).reshape(b, n)
    rank_of_pos = (scores > scores[:, :1]).sum(dim=1)
    return (rank_of_pos < k).float().mean()
