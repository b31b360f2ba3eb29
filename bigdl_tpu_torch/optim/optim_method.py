"""Optimization methods (``bigdl_tpu/optim/optim_method.py``): SGD, Adam
(AdamW as its decoupled-decay flag), Adagrad and the learning-rate
schedules.

Parity: ``optim/SGD.scala:26-209``, ``optim/Adagrad.scala``; Adam, AdamW,
Warmup and Cosine have no Scala counterpart and follow the JAX package.
``clr`` is the NEGATIVE current rate (``w + clr * g``), evaluated on the
host by the schedule and handed to the update in ``config["clr"]``;
without it the update applies the ``Default`` schedule on the step
counter.  ``torch.optim.SGD`` is not used: its sign convention and its
first momentum step differ (see :meth:`SGD.update`).

``params`` and ``grads`` are lists of tensors in the model's leaf order;
the update is plain tensor code under ``torch.no_grad()`` and returns new
tensors, so the caller can keep the old ones (the non-finite guard does).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from bigdl_tpu_torch.utils.table import T, Table


class OptimMethod:

    def init_state(self, params) -> dict:
        return {}

    def update(self, grads, params, opt_state, config: Table, step: int):
        """Returns ``(new_params, new_opt_state)``; ``step`` is the 0-based
        iteration counter."""
        raise NotImplementedError


# --- learning-rate schedules (``optim/SGD.scala:128-209``) -----------------

class LearningRateSchedule:
    def current_rate(self, config: Table, state: Table) -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """clr = -lr / (1 + nevals * lrDecay)."""

    def current_rate(self, config, state):
        lr = config.get("learningRate", 1e-3)
        lrd = config.get("learningRateDecay", 0.0)
        nevals = state.get("evalCounter", 0)
        return -lr / (1 + nevals * lrd)


class Poly(LearningRateSchedule):
    """clr = -lr * (1 - iter/maxIter)^power; 0 after maxIter."""

    def __init__(self, power: float, max_iteration: int):
        self.power = power
        self.max_iteration = max_iteration

    def current_rate(self, config, state):
        lr = config.get("learningRate", 1e-3)
        it = state.get("evalCounter", 0)
        if it > self.max_iteration:
            return 0.0
        return -lr * (1 - it / self.max_iteration) ** self.power


class Step(LearningRateSchedule):
    """clr = -lr * gamma^(floor(iter / stepSize))."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size = step_size
        self.gamma = gamma

    def current_rate(self, config, state):
        lr = config.get("learningRate", 1e-3)
        it = state.get("evalCounter", 0)
        return -lr * self.gamma ** (it // self.step_size)


class EpochStep(LearningRateSchedule):
    """Multiply by gamma every ``step_size`` epochs."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size = step_size
        self.gamma = gamma

    def current_rate(self, config, state):
        lr = config.get("learningRate", 1e-3)
        epoch = state.get("epoch", 1)
        return -lr * self.gamma ** ((epoch - 1) // self.step_size)


class EpochDecay(LearningRateSchedule):
    """clr = -lr * 0.1^decay_fn(epoch)."""

    def __init__(self, decay_fn: Callable[[int], float]):
        self.decay_fn = decay_fn

    def current_rate(self, config, state):
        lr = config.get("learningRate", 1e-3)
        return -lr * (0.1 ** self.decay_fn(state.get("epoch", 1)))


class Regime:
    """Hyperparameters ``config`` for the epochs ``start_epoch`` to
    ``end_epoch`` (both included)."""

    def __init__(self, start_epoch: int, end_epoch: int, config: Table):
        self.start_epoch, self.end_epoch = start_epoch, end_epoch
        self.config = config


class EpochSchedule(LearningRateSchedule):
    """Per-epoch-range regimes (``SGD.EpochSchedule``): each regime that
    holds the epoch updates the config, and the rate is its
    ``learningRate``."""

    def __init__(self, regimes):
        self.regimes = list(regimes)

    def current_rate(self, config, state):
        epoch = state.get("epoch", 1)
        for r in self.regimes:
            if r.start_epoch <= epoch <= r.end_epoch:
                config.update_(r.config)
        return -config.get("learningRate", 1e-3)


class Warmup(LearningRateSchedule):
    """Linear warmup: clr = -lr * (iter + 1) / warmup_iterations for the
    first ``warmup_iterations`` iterations (``evalCounter``, 0-based), then
    ``after`` with the counter re-zeroed at the boundary (so a decay starts
    from the peak), or -lr without it."""

    def __init__(self, warmup_iterations: int,
                 after: Optional[LearningRateSchedule] = None):
        self.warmup_iterations = warmup_iterations
        self.after = after

    def current_rate(self, config, state):
        lr = config.get("learningRate", 1e-3)
        it = state.get("evalCounter", 0)
        if it < self.warmup_iterations:
            return -lr * (it + 1) / self.warmup_iterations
        if self.after is not None:
            shifted = T()
            shifted.update_(state)
            shifted["evalCounter"] = it - self.warmup_iterations
            return self.after.current_rate(config, shifted)
        return -lr


class Cosine(LearningRateSchedule):
    """Cosine decay from lr to ``min_ratio * lr`` over ``max_iteration``
    iterations, the floor held after."""

    def __init__(self, max_iteration: int, min_ratio: float = 0.0):
        self.max_iteration = max_iteration
        self.min_ratio = min_ratio

    def current_rate(self, config, state):
        lr = config.get("learningRate", 1e-3)
        it = min(state.get("evalCounter", 0), self.max_iteration)
        cos = 0.5 * (1 + math.cos(math.pi * it / self.max_iteration))
        return -lr * (self.min_ratio + (1 - self.min_ratio) * cos)


class SGD(OptimMethod):

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0,
                 momentum: float = 0.0,
                 dampening: Optional[float] = None,
                 nesterov: bool = False,
                 learning_rate_schedule: Optional[LearningRateSchedule]
                 = None):
        self.defaults = T(
            learningRate=learning_rate,
            learningRateDecay=learning_rate_decay,
            weightDecay=weight_decay,
            momentum=momentum,
            dampening=momentum if dampening is None else dampening,
            nesterov=nesterov,
        )
        self.schedule = learning_rate_schedule or Default()

    def _config(self, config: Optional[Table]) -> Table:
        c = self.defaults.clone()
        if config:
            c.update_(config)
        return c

    def init_state(self, params):
        return {"velocity": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, grads, params, opt_state, config: Table, step: int):
        """Weight decay, then momentum: at step 0 the velocity IS the
        gradient (``optim_method.py:226-228``), later ``v * mom + (1 - damp)
        * g``; a zero-initialised buffer would give another first step
        whenever ``dampening != 0``."""
        c = self._config(config)
        wd = c.get("weightDecay", 0.0)
        mom = c.get("momentum", 0.0)
        damp = c.get("dampening", mom)
        nesterov = c.get("nesterov", False)
        clr = c.get("clr", None)
        if clr is None:
            clr = -c.get("learningRate", 1e-3) / (
                1 + step * c.get("learningRateDecay", 0.0))

        if wd > 0:
            grads = [g + wd * w for g, w in zip(grads, params)]
        vel = opt_state["velocity"]
        if mom > 0:
            if step == 0:
                vel = [g.clone() for g in grads]
            else:
                vel = [v * mom + (1 - damp) * g for v, g in zip(vel, grads)]
            eff = [g + mom * v for g, v in zip(grads, vel)] if nesterov \
                else vel
        else:
            eff = grads
        new_params = [w + clr * g for w, g in zip(params, eff)]
        return new_params, {"velocity": vel}


class Adam(OptimMethod):
    """Adam with bias correction (Kingma & Ba), ``eps`` outside the
    bias-corrected square root; the rate comes from
    ``learning_rate_schedule`` through ``config["clr"]`` as SGD's does.
    ``weight_decay`` is added to the gradient (L2), or with ``decoupled``
    taken off the weight after the step (``new -= lr * wd * w``, Loshchilov
    & Hutter; :class:`AdamW`)."""

    def __init__(self, learning_rate: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.0,
                 learning_rate_schedule: Optional[LearningRateSchedule]
                 = None, decoupled: bool = False):
        self.defaults = T(learningRate=learning_rate, beta1=beta1,
                          beta2=beta2, epsilon=epsilon,
                          weightDecay=weight_decay)
        self.schedule = learning_rate_schedule or Default()
        self.decoupled = decoupled

    def init_state(self, params):
        return {"m": [torch.zeros_like(p) for p in params],
                "v": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, grads, params, opt_state, config: Table, step: int):
        c = self.defaults.clone()
        if config:
            c.update_(config)
        b1, b2 = c.get("beta1", 0.9), c.get("beta2", 0.999)
        eps = c.get("epsilon", 1e-8)
        wd = c.get("weightDecay", 0.0)
        clr = c.get("clr", None)
        lr = -clr if clr is not None else c.get("learningRate", 1e-3)
        if wd > 0 and not self.decoupled:
            grads = [g + wd * w for g, w in zip(grads, params)]
        m = [b1 * mm + (1 - b1) * g for mm, g in zip(opt_state["m"], grads)]
        v = [b2 * vv + (1 - b2) * g * g
             for vv, g in zip(opt_state["v"], grads)]
        t = float(step + 1)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        new_params = [w - (lr / bc1) * mm / (torch.sqrt(vv / bc2) + eps)
                      for w, mm, vv in zip(params, m, v)]
        if wd > 0 and self.decoupled:
            new_params = [n - lr * wd * w for n, w in zip(new_params, params)]
        return new_params, {"m": m, "v": v}


def AdamW(learning_rate: float = 1e-3, beta1: float = 0.9,
          beta2: float = 0.999, epsilon: float = 1e-8,
          weight_decay: float = 0.01,
          learning_rate_schedule: Optional[LearningRateSchedule] = None
          ) -> Adam:
    """:class:`Adam` with decoupled weight decay (0.01 by default)."""
    return Adam(learning_rate, beta1, beta2, epsilon, weight_decay,
                learning_rate_schedule, decoupled=True)


class Adagrad(OptimMethod):
    """Accumulated squared gradients (``optim/Adagrad.scala``): the rate
    lr / (1 + step * lrDecay) from the step counter, the update
    ``w - clr * g / (sqrt(v) + 1e-10)``."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0):
        self.defaults = T(learningRate=learning_rate,
                          learningRateDecay=learning_rate_decay,
                          weightDecay=weight_decay)

    def init_state(self, params):
        return {"variance": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, grads, params, opt_state, config: Table, step: int):
        c = self.defaults.clone()
        if config:
            c.update_(config)
        wd = c.get("weightDecay", 0.0)
        if wd > 0:
            grads = [g + wd * w for g, w in zip(grads, params)]
        clr = c.get("learningRate", 1e-3) / \
            (1 + step * c.get("learningRateDecay", 0.0))
        var = [v + g * g for v, g in zip(opt_state["variance"], grads)]
        new_params = [w - clr * g / (torch.sqrt(v) + 1e-10)
                      for w, g, v in zip(params, grads, var)]
        return new_params, {"variance": var}
