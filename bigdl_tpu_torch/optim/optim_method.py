"""Optimization methods (``bigdl_tpu/optim/optim_method.py``): SGD, Adam and
the learning-rate schedules, Warmup among them.

Parity: ``optim/SGD.scala:26-209``; Adam and Warmup have no Scala
counterpart and follow the JAX package.  ``clr`` is the NEGATIVE current rate
(``w + clr * g``), evaluated on the host by the schedule and handed to the
update in ``config["clr"]``; without it the update applies the ``Default``
schedule on the step counter.  ``torch.optim.SGD`` is not used: its sign
convention and its first momentum step differ (see :meth:`SGD.update`).

``params`` and ``grads`` are lists of tensors in the model's leaf order;
the update is plain tensor code under ``torch.no_grad()`` and returns new
tensors, so the caller can keep the old ones (the non-finite guard does).
"""

from __future__ import annotations

from typing import Optional

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


class Warmup(LearningRateSchedule):
    """Linear warmup: clr = -lr * (iter + 1) / warmup_iterations for the
    first ``warmup_iterations`` iterations (``evalCounter``, 0-based), then
    -lr.  The reference's ``after`` (a schedule taking over at the end of
    the ramp) comes with the other schedules of the optim-methods slice."""

    def __init__(self, warmup_iterations: int, after=None):
        if after is not None:
            raise NotImplementedError(
                "Warmup(after=...) comes with the optim-methods slice of the "
                "port (EpochDecay, EpochSchedule, Cosine)")
        self.warmup_iterations = warmup_iterations

    def current_rate(self, config, state):
        lr = config.get("learningRate", 1e-3)
        it = state.get("evalCounter", 0)
        if it < self.warmup_iterations:
            return -lr * (it + 1) / self.warmup_iterations
        return -lr


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
    """Adam with bias correction (Kingma & Ba), ``weight_decay`` added to
    the gradient (L2, not decoupled), ``eps`` outside the bias-corrected
    square root; the rate comes from ``learning_rate_schedule`` through
    ``config["clr"]`` as SGD's does."""

    def __init__(self, learning_rate: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.0,
                 learning_rate_schedule: Optional[LearningRateSchedule]
                 = None):
        self.defaults = T(learningRate=learning_rate, beta1=beta1,
                          beta2=beta2, epsilon=epsilon,
                          weightDecay=weight_decay)
        self.schedule = learning_rate_schedule or Default()

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
        if wd > 0:
            grads = [g + wd * w for g, w in zip(grads, params)]
        m = [b1 * mm + (1 - b1) * g for mm, g in zip(opt_state["m"], grads)]
        v = [b2 * vv + (1 - b2) * g * g
             for vv, g in zip(opt_state["v"], grads)]
        t = float(step + 1)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        new_params = [w - (lr / bc1) * mm / (torch.sqrt(vv / bc2) + eps)
                      for w, mm, vv in zip(params, m, v)]
        return new_params, {"m": m, "v": v}
