"""LR schedules (port of ``repro.optim.schedules``): WSD (minicpm), cosine,
the paper's step decay (ResNet), constant.  Each is ``step -> lr`` as a Python float holding the f32 value
the reference computes."""
from __future__ import annotations

import math

import numpy as np

_F = np.float32


def wsd(base_lr: float, warmup: int, stable: int, decay: int):
    """Warmup-Stable-Decay (MiniCPM): linear warmup, flat, then halving
    every ``decay`` steps."""
    def fn(step):
        step = _F(step)
        warm = _F(base_lr) * min(step / _F(max(warmup, 1)), _F(1.0))
        in_decay = max(step - _F(warmup + stable), _F(0.0))
        return float(warm * _F(0.5) ** (in_decay / _F(max(decay, 1))))
    return fn


def cosine(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    def fn(step):
        step = _F(step)
        warm = min(step / _F(max(warmup, 1)), _F(1.0))
        prog = np.clip((step - _F(warmup)) / _F(max(total - warmup, 1)),
                       _F(0.0), _F(1.0))
        cos = _F(min_frac) + _F(1 - min_frac) * _F(0.5) * (
            _F(1.0) + np.cos(_F(math.pi) * prog))
        return float(_F(base_lr) * warm * cos)
    return fn


def step_decay(base_lr: float, boundaries, factor: float = 0.1):
    """The paper's ResNet schedule: x ``factor`` at each boundary step."""
    def fn(step):
        step = _F(step)
        mult = _F(1.0)
        for b in boundaries:
            if step >= _F(b):
                mult = mult * _F(factor)
        return float(_F(base_lr) * mult)
    return fn


def constant(base_lr: float):
    return lambda step: float(_F(base_lr))


def make_schedule(name: str, base_lr: float, total_steps: int,
                  warmup: int = 0):
    if name == "wsd":
        stable = int(total_steps * 0.8) - warmup
        return wsd(base_lr, warmup, max(stable, 1),
                   max(total_steps - warmup - stable, 1))
    if name == "cosine":
        return cosine(base_lr, warmup, total_steps)
    if name == "constant":
        return constant(base_lr)
    raise ValueError(name)
