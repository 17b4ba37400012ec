"""PyTorch + CUDA port of the S2FP8 stack (``src/repro`` is the JAX reference).

The layout mirrors ``repro`` module for module so each counterpart is easy
to find.  The package imports ``torch`` and never ``jax`` or ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that explicit request they raise
(:func:`resolve_device`)."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, ``cpu`` only
    when asked for.  Raises when CUDA is wanted but absent — never a quiet
    drop to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
