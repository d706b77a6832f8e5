"""Learning-rate schedules, step → value (counterpart of the JAX package's
`utils/schedules.py`, Keras schedule semantics).

Name and parameter registry match the reference (`schedules.py:17-110`), so
SCHEDULE / SCHEDULE_PARAMS config entries work unchanged:
  - ExponentialDecay(initial_learning_rate, decay_steps, decay_rate, staircase)
  - ExponentialDecayWithSteps: two-tier staircase — a small decay every
    `decay_steps` plus an extra large decay every `large_decay_steps`
    (the small-decay exponent is reduced by the large-decay count)
  - PiecewiseConstantDecay(boundaries, values)
  - CosineDecayRestarts(initial_learning_rate, first_decay_steps, t_mul, m_mul, alpha)

Every schedule computes in float32, as the JAX package does, and returns a
0-dim float32 CPU tensor; the step is the pre-increment one (0 for the first
update).
"""

from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32)


def exponential_decay(initial_learning_rate, decay_steps, decay_rate, staircase=False,
                      name=None):
    def schedule(step):
        p = _f32(step) / decay_steps
        if staircase:
            p = torch.floor(p)
        return initial_learning_rate * torch.pow(_f32(decay_rate), p)
    return schedule


def exponential_decay_with_steps(initial_learning_rate, decay_steps, decay_rate,
                                 large_decay_steps, large_decay_rate, name=None):
    def schedule(step):
        step = _f32(step)
        p = torch.floor(step / decay_steps)
        large_p = torch.floor(step / large_decay_steps)
        decayed = initial_learning_rate * torch.pow(_f32(decay_rate), p - large_p)
        return decayed * torch.pow(_f32(large_decay_rate), large_p)
    return schedule


def piecewise_constant_decay(boundaries, values, name=None):
    def schedule(step):
        step = _f32(step)
        value = _f32(values[0])
        for boundary, v in zip(boundaries, values[1:]):
            value = torch.where(step > boundary, _f32(v), value)
        return value
    return schedule


def cosine_decay_restarts(initial_learning_rate, first_decay_steps, t_mul=2.0,
                          m_mul=1.0, alpha=0.0, name=None):
    def schedule(step):
        completed = _f32(step) / first_decay_steps
        if t_mul == 1.0:
            i_restart = torch.floor(completed)
            frac = completed - i_restart
        else:
            i_restart = torch.floor(
                torch.log1p(completed * (t_mul - 1.0)) / _f32(math.log(t_mul)))
            sum_r = (torch.pow(_f32(t_mul), i_restart) - 1.0) / (t_mul - 1.0)
            frac = (completed - sum_r) / torch.pow(_f32(t_mul), i_restart)
        m_fac = torch.pow(_f32(m_mul), i_restart)
        cosine = 0.5 * m_fac * (1.0 + torch.cos(_f32(math.pi) * frac))
        return initial_learning_rate * ((1.0 - alpha) * cosine + alpha)
    return schedule


_REGISTRY = {
    "ExponentialDecay": exponential_decay,
    "ExponentialDecayWithSteps": exponential_decay_with_steps,
    "PiecewiseConstantDecay": piecewise_constant_decay,
    "CosineDecayRestarts": cosine_decay_restarts,
}


def scheduler_by_name(name):
    if name not in _REGISTRY:
        raise NotImplementedError(name)
    return _REGISTRY[name]
