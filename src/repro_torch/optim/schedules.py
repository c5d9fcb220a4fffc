"""Learning-rate schedules as step -> lr callables (port of ``repro.optim.schedules``).

The reference evaluates a schedule in f32 on its device; the port evaluates
the same f32 operations, in the same order, as 0-d f32 tensors on the CPU,
and returns one.  PyTorch's f32 ``cos`` is within 1 ulp of XLA's, and ``1 +
cos`` near ``cos = -1`` magnifies that: a value is within ``lr·2**-24`` plus
1 ulp of the reference's, most are bit-equal (tests/test_torch_optim.py).
"""

from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.0):
    def f(step):
        t = torch.clamp(_f32(int(step)) / max(total_steps, 1), 0.0, 1.0)
        c = 0.5 * (1 + torch.cos(math.pi * t))
        return _f32(lr) * (final_frac + (1 - final_frac) * c)

    return f


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.0):
    cd = cosine_decay(lr, max(total_steps - warmup_steps, 1), final_frac)

    def f(step):
        step = int(step)
        if step < warmup_steps:
            return _f32(lr) * _f32(step) / max(warmup_steps, 1)
        return cd(step - warmup_steps)

    return f
