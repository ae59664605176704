"""Learning-rate decay schedules as program sub-graphs (counterpart of
``paddle_tpu/lr_decay.py``; reference: fluid/learning_rate_decay.py and
v1 LearningRateScheduler.cpp).

Each schedule reads the persistable ``@STEP_COUNTER@``
(``layers.autoincreased_step_counter``), which an ``increment`` op
advances once per run of the program, so the decayed rate is computed
inside the step (a CUDA graph replay on a card) and travels in a
checkpoint with the rest of the scope.  The ops are the JAX package's,
in the same order, so both packages build the same program.
"""
from __future__ import annotations

import math

from . import layers

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay",
           "v1_poly_decay"]


def _global_step_f32():
    counter = layers.autoincreased_step_counter(begin=0)
    return layers.cast(counter, "float32")


def _step_div(decay_steps, staircase):
    div = layers.scale(_global_step_f32(), scale=1.0 / decay_steps)
    if staircase:
        div = layers.floor(div)
    return div


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * decay_rate ^ (step / decay_steps), as exp(div * ln(rate))."""
    div = _step_div(decay_steps, staircase)
    return layers.scale(
        layers.exp(layers.scale(div, scale=math.log(decay_rate))),
        scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * exp(-decay_rate * step / decay_steps)."""
    div = _step_div(decay_steps, staircase)
    return layers.scale(layers.exp(layers.scale(div, scale=-decay_rate)),
                        scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate * step / decay_steps)."""
    div = _step_div(decay_steps, staircase)
    denom = layers.scale(div, scale=decay_rate, bias=1.0)
    return layers.scale(layers.reciprocal(denom),
                        scale=float(learning_rate))


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    """(lr - end) * (1 - step / steps) ^ power + end, the step held at
    ``decay_steps`` (or, with ``cycle``, ``steps`` the next multiple of
    ``decay_steps``)."""
    gs = _global_step_f32()
    if cycle:
        ratio = layers.scale(gs, scale=1.0 / decay_steps)
        mult = layers.elementwise_max(
            layers.ceil(ratio), layers.fill_constant([1], "float32", 1.0))
        steps = layers.scale(mult, scale=float(decay_steps))
    else:
        steps = layers.fill_constant([1], "float32", float(decay_steps))
        gs = layers.elementwise_min(gs, steps)
    frac = layers.elementwise_div(gs, steps)
    one_minus = layers.scale(frac, scale=-1.0, bias=1.0)
    powed = layers.pow(one_minus, factor=power)
    return layers.scale(powed,
                        scale=float(learning_rate - end_learning_rate),
                        bias=float(end_learning_rate))


def piecewise_decay(boundaries, values):
    """Piecewise-constant rate: values[i] while step < boundaries[i],
    built from the last boundary backwards with where-selects."""
    assert len(values) == len(boundaries) + 1
    gs = _global_step_f32()
    lr = layers.fill_constant([1], "float32", float(values[-1]))
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        cond = layers.less_than(
            gs, layers.fill_constant([1], "float32", float(b)))
        ie_val = layers.fill_constant([1], "float32", float(v))
        lr = layers.elementwise_add(
            layers.elementwise_mul(layers.cast(cond, "float32"), ie_val),
            layers.elementwise_mul(
                layers.scale(layers.cast(cond, "float32"), scale=-1.0,
                             bias=1.0), lr))
    return lr


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """Transformer rate: d^-0.5 * min(step^-0.5, step * warmup^-1.5)."""
    gs = layers.elementwise_max(
        _global_step_f32(), layers.fill_constant([1], "float32", 1.0))
    a = layers.pow(gs, factor=-0.5)
    b = layers.scale(gs, scale=warmup_steps ** -1.5)
    return layers.scale(layers.elementwise_min(a, b),
                        scale=float(learning_rate) * d_model ** -0.5)


def v1_poly_decay(learning_rate, decay_a, decay_b, batch_size=1):
    """v1's default schedule: lr * (1 + decay_a * samples) ^ -decay_b,
    the samples advancing by ``batch_size`` a step, as
    exp(-b * log(base))."""
    samples = layers.scale(_global_step_f32(), scale=float(batch_size))
    base = layers.scale(samples, scale=float(decay_a), bias=1.0)
    return layers.scale(
        layers.exp(layers.scale(layers.log(base), scale=-float(decay_b))),
        scale=float(learning_rate))
