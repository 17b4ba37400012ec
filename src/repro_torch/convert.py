"""Carry weights across from the JAX package.

``params_from_jax(tree)`` takes the tree ``repro.launch.api.init_params``
returns — as numpy arrays (``jax.device_get``), or any array type numpy
can read — and gives the port's params: the same stacked segments, the
same leaf names, the same layout ([d_in, d_out] weights, [L]-stacked
layers), MoE blocks included (``moe/router`` [L, d, E], the stacked
experts ``moe/we_gate``, ``we_up`` [L, E, d, f] and ``we_down`` [L, E, f,
d], ``moe/shared/*``), mamba1 blocks (``ln``, ``w_in`` [L, d, 2di],
``conv_w`` [L, K, di], ``conv_b``, ``w_x`` [L, di, dt_rank + 2n], ``w_dt``
[L, dt_rank, di], ``b_dt``, ``a_log`` [L, di, n], ``d_skip`` [L, di],
``w_out`` [L, di, d]) and the untied ``head``.  The same call carries
the paper's models: ``repro.models.encdec.init_encdec``'s tree (``embed``,
``head``, ``enc_norm``, ``dec_norm``, the [L]-stacked ``encoder`` blocks
and ``decoder`` blocks with their ``self`` / ``cross`` projections and
layer norms' ``bias``), ``repro.models.resnet.init_resnet``'s (params,
state) (HWIO kernels, ``blocks`` a list of dicts, ``bns`` an empty list,
the batch norms' running ``mean`` / ``var``) and
``repro.models.ncf.init_ncf``'s tree (the tables, ``mlp`` a list).  Lists
stay lists and dicts keep their keys.  The two frameworks draw
different random numbers from the same seed, so parity tests start both
sides from these converted params.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device


def params_from_jax(tree: Any, device=None) -> Any:
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.as_tensor(np.array(node, dtype=np.float32), device=dev)

    return conv(tree)
