"""Kernel layer: hand-written CUDA kernels for Hopper (``repro_torch/csrc``),
their plain PyTorch versions, the oracles (``ref``) and the shape layer
(``dispatch``).

Every kernel module pairs a wrapper with a plain version of the same
function.  A wrapper takes the plain version only for a tensor on the CPU;
for a CUDA tensor it launches its kernel or raises.  Each wrapper keeps an
integer ``launches`` count (incremented where it launches, nowhere else)
and each plain version a ``calls`` count, so a run can show which path
served it (:func:`counts`, :func:`reset_counts`).

Each wrapper is marked with :func:`kernel_entry` under its registry name:
while an observer is installed (:func:`observe`, which
``roofline/trace_cost.py`` uses to charge a call as the kernel it stands
for), every call goes through the observer; otherwise the mark costs one
Python call.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List, Tuple

_OBSERVER: List = [None]


def kernel_entry(name: str) -> Callable:
    """Mark a wrapper as the entry point of kernel ``name``: with an
    observer installed, a call becomes ``observer(name, fn, args,
    kwargs)``, which must call ``fn`` and return its result."""
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            obs = _OBSERVER[0]
            if obs is None:
                return fn(*args, **kwargs)
            return obs(name, fn, args, kwargs)
        entry.kernel_name = name
        return entry
    return deco


@contextlib.contextmanager
def observe(observer: Callable):
    """Route every kernel wrapper's calls through ``observer`` while open
    (process-wide, so the autograd engine's threads see it too)."""
    prev = _OBSERVER[0]
    _OBSERVER[0] = observer
    try:
        yield observer
    finally:
        _OBSERVER[0] = prev


def plain_version(fn: Callable) -> Callable:
    """Mark ``fn`` as a kernel's plain PyTorch version and count its calls."""
    @functools.wraps(fn)
    def counted(*args, **kwargs):
        counted.calls += 1
        return fn(*args, **kwargs)

    counted.calls = 0
    return counted


def registry() -> Dict[str, Tuple[Callable, Callable]]:
    """kernel name -> (wrapper, plain version), for the sixteen kernels
    of the serving, dense training, MoE training, exact-stats (fused-stats
    engine) and SSM slices (the selective scan and its backward), and the
    plain flash forward of ``kernels.ops``."""
    from repro_torch.kernels import (flash_attention, paged_attention,
                                     s2fp8_matmul, s2fp8_quant,
                                     selective_scan)
    return {
        "quant_apply": (s2fp8_quant.quant_apply,
                        s2fp8_quant.quant_apply_plain),
        "truncate_apply": (s2fp8_quant.truncate_apply,
                           s2fp8_quant.truncate_apply_plain),
        "dequant": (s2fp8_quant.dequant, s2fp8_quant.dequant_plain),
        "stats": (s2fp8_quant.stats_partials,
                  s2fp8_quant.stats_partials_plain),
        "quant": (s2fp8_quant.quant, s2fp8_quant.quant_plain),
        "truncate_fused": (s2fp8_quant.truncate_fused,
                           s2fp8_quant.truncate_fused_plain),
        "qmatmul_nn": (s2fp8_matmul.qmatmul_nn, s2fp8_matmul.qmatmul_plain),
        "qmatmul_nt": (s2fp8_matmul.qmatmul_nt,
                       s2fp8_matmul.qmatmul_nt_plain),
        "qmatmul_tn": (s2fp8_matmul.qmatmul_tn,
                       s2fp8_matmul.qmatmul_tn_plain),
        "qmatmul_batched": (s2fp8_matmul.qmatmul_batched,
                            s2fp8_matmul.qmatmul_batched_plain),
        "qflash_fwd": (flash_attention.qflash_fwd,
                       flash_attention.qflash_fwd_plain),
        "qflash_bwd": (flash_attention.qflash_bwd,
                       flash_attention.qflash_bwd_plain),
        "paged_decode": (paged_attention.paged_decode_attention,
                         paged_attention.paged_decode_plain),
        "selective_scan": (selective_scan.selective_scan,
                           selective_scan.selective_scan_plain),
        "selective_scan_bwd": (selective_scan.selective_scan_bwd,
                               selective_scan.selective_scan_bwd_plain),
        "flash_fwd": (flash_attention.flash_attention,
                      flash_attention.flash_attention_plain),
    }


def counts() -> Dict[str, Dict[str, int]]:
    return {name: {"launches": w.launches, "plain_calls": p.calls}
            for name, (w, p) in registry().items()}


def reset_counts() -> None:
    for w, p in registry().values():
        w.launches = 0
        p.calls = 0
        if hasattr(w, "small_launches"):   # the GEMM's decode-path share
            w.small_launches = 0
