"""Learning-rate schedules (port of ``repro.optim.schedules``) as host
functions of the host step: each returns the f32 learning rate as a Python
float, so the train step passes it to the update kernels with no device
sync."""
from __future__ import annotations

import math

import numpy as np

_f32 = np.float32


def constant(lr: float):
    return lambda step: float(_f32(lr))


def cosine(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    """Linear warmup, then cosine decay to ``final_frac · lr`` (f32 math, as
    the reference's)."""

    def f(step):
        s = _f32(step)
        if s < warmup:
            return float(_f32(lr) * s / _f32(max(warmup, 1)))
        prog = np.clip((s - _f32(warmup)) / _f32(max(total - warmup, 1)), _f32(0), _f32(1))
        cos = _f32(final_frac * lr) + _f32((1 - final_frac) * lr) * _f32(0.5) * (
            _f32(1) + np.cos(_f32(math.pi) * prog))
        return float(_f32(cos))

    return f


def wsd(lr: float, warmup: int, stable: int, decay: int, final_frac: float = 0.01):
    """Warmup-Stable-Decay (MiniCPM): linear warmup, a flat stage, then an
    exponential tail to ``final_frac · lr``."""

    def f(step):
        s = _f32(step)
        if s < warmup:
            return float(_f32(lr) * s / _f32(max(warmup, 1)))
        if s < warmup + stable:
            return float(_f32(lr))
        prog = np.clip((s - _f32(warmup + stable)) / _f32(max(decay, 1)), _f32(0), _f32(1))
        return float(_f32(lr) * np.power(_f32(final_frac), prog))

    return f
