"""Optimization methods (``bigdl_tpu/optim/optim_method.py``): SGD, Adam
(AdamW as its decoupled-decay flag), Adagrad, LBFGS and the learning-rate
schedules.

Parity: ``optim/SGD.scala:26-209``, ``optim/Adagrad.scala``,
``optim/LBFGS.scala`` with ``optim/LineSearch.scala``; Adam, AdamW, Warmup
and Cosine have no Scala counterpart and follow the JAX package.
``clr`` is the NEGATIVE current rate (``w + clr * g``), evaluated on the
host by the schedule and handed to the update in ``config["clr"]``;
without it the update applies the ``Default`` schedule on the step
counter.  ``torch.optim.SGD`` is not used: its sign convention and its
first momentum step differ (see :meth:`SGD.update`).

``params`` and ``grads`` are lists of tensors in the model's leaf order;
the update is plain tensor code under ``torch.no_grad()`` and returns new
tensors, so the caller can keep the old ones (the non-finite guard does).

The Torch-style ``optimize(feval, x, config, state)``
(``optim/OptimMethod.scala``) takes ``x`` as a tensor or a dict or list of
tensors, calls ``feval(x) -> (loss, dfdx)`` with ``dfdx`` in ``x``'s
structure (``feval`` may run autograd: only the update runs under
``torch.no_grad()``), and returns ``(new_x, [losses])``; the update is
plain tensor code on ``x``'s device, and its history (``evalCounter``,
momentum, moments) accumulates in ``state``; without one, Adam keeps it in
``config`` (torch's ``state = state or config``) and SGD and Adagrad in a
copy of their defaults, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from bigdl_tpu_torch.core.module import tree_leaves
from bigdl_tpu_torch.utils.table import T, Table


def _tmap(fn, *trees):
    """``fn`` over the leaves of trees of one structure (a tensor, or dicts
    and lists of them) in ``tree_leaves``' order (a dict's entries by
    sorted key), the result in that structure."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in sorted(head)}
    if isinstance(head, (list, tuple)):
        return type(head)(_tmap(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _flat(tree) -> torch.Tensor:
    """Every leaf of ``tree`` raveled into one 1-D tensor, in
    ``tree_leaves``' order."""
    return torch.cat([leaf.reshape(-1) for leaf in tree_leaves(tree)])


def _unflat(flat: torch.Tensor, like):
    """``flat`` cut back into ``like``'s structure, shapes and dtypes."""
    pos = [0]

    def take(leaf):
        n = leaf.numel()
        out = flat[pos[0]:pos[0] + n].reshape(leaf.shape).to(leaf.dtype)
        pos[0] += n
        return out
    return _tmap(take, like)


class OptimMethod:

    def optimize(self, feval, x, config: Optional[Table] = None,
                 state: Optional[Table] = None):
        """One Torch-style step: ``(new_x, [losses])``."""
        raise NotImplementedError

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

    def optimize(self, feval, x, config: Optional[Table] = None,
                 state: Optional[Table] = None):
        """Weight decay, then momentum kept in ``state["dfdx"]`` (the
        gradient itself the first time), then ``x + clr * dfdx`` with the
        schedule's rate on ``state["evalCounter"]`` (times
        ``learningRates`` where the config has them)."""
        c = self._config(config)
        s = state if state is not None else c
        wd = c.get("weightDecay", 0.0)
        mom = c.get("momentum", 0.0)
        damp = c.get("dampening", mom)
        nesterov = c.get("nesterov", False)
        if nesterov and not (mom > 0 and damp == 0):
            raise ValueError(
                "nesterov requires momentum > 0 and dampening = 0")
        loss, dfdx = feval(x)
        clr = self.schedule.current_rate(c, s)
        with torch.no_grad():
            if wd > 0:
                dfdx = _tmap(lambda g, w: g + wd * w, dfdx, x)
            if mom > 0:
                if "dfdx" not in s:
                    s["dfdx"] = _tmap(torch.clone, dfdx)
                else:
                    s["dfdx"] = _tmap(lambda v, g: v * mom + (1 - damp) * g,
                                      s["dfdx"], dfdx)
                dfdx = _tmap(lambda g, v: g + mom * v, dfdx, s["dfdx"]) \
                    if nesterov else s["dfdx"]
            lrs = c.get("learningRates", None)
            scale = clr if lrs is None else clr * lrs
            x = _tmap(lambda w, g: w + scale * g, x, dfdx)
        s["evalCounter"] = s.get("evalCounter", 0) + 1
        return x, [loss]

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

    def optimize(self, feval, x, config: Optional[Table] = None,
                 state: Optional[Table] = None):
        """:meth:`update` on ``x``'s leaves with the schedule's rate on
        ``evalCounter``; the moments live in ``state["adamState"]``."""
        c = self.defaults.clone()
        if config:
            c.update_(config)
        if state is not None:
            s = state
        elif config is not None:
            s = config          # torch: accumulate in the config
        else:
            s = c
        loss, dfdx = feval(x)
        params = list(tree_leaves(x))
        if "adamState" not in s:
            s["adamState"] = self.init_state(params)
        nevals = s.get("evalCounter", 0)
        c["clr"] = self.schedule.current_rate(c, s)
        new, s["adamState"] = self.update(list(tree_leaves(dfdx)), params,
                                          s["adamState"], c, nevals)
        s["evalCounter"] = nevals + 1
        it = iter(new)
        return _tmap(lambda _: next(it), x), [loss]

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

    def optimize(self, feval, x, config: Optional[Table] = None,
                 state: Optional[Table] = None):
        """Weight decay, then ``state["paramVariance"]`` (the squared
        gradient the first time, summed after) and the step at the rate of
        ``evalCounter``."""
        c = self.defaults.clone()
        if config:
            c.update_(config)
        s = state if state is not None else c
        loss, dfdx = feval(x)
        wd = c.get("weightDecay", 0.0)
        nevals = s.get("evalCounter", 0)
        clr = c.get("learningRate", 1e-3) / \
            (1 + nevals * c.get("learningRateDecay", 0.0))
        with torch.no_grad():
            if wd > 0:
                dfdx = _tmap(lambda g, w: g + wd * w, dfdx, x)
            if "paramVariance" not in s:
                s["paramVariance"] = _tmap(lambda g: g * g, dfdx)
            else:
                s["paramVariance"] = _tmap(lambda v, g: v + g * g,
                                           s["paramVariance"], dfdx)
            x = _tmap(lambda w, g, v: w - clr * g / (torch.sqrt(v) + 1e-10),
                      x, dfdx, s["paramVariance"])
        s["evalCounter"] = nevals + 1
        return x, [loss]

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


class LBFGS(OptimMethod):
    """Compact L-BFGS with an optional strong-Wolfe line search
    (``optim/LBFGS.scala``, ``optim/LineSearch.scala``): a full-batch method
    for small problems.  ``optimize`` runs up to ``max_iter`` iterations on
    ``x`` raveled into one tensor on its device and returns ``(new_x,
    losses)``, the loss at the start and after each iteration."""

    def __init__(self, max_iter: int = 20, max_eval: Optional[float] = None,
                 tol_fun: float = 1e-5, tol_x: float = 1e-9,
                 n_correction: int = 100, learning_rate: float = 1.0,
                 line_search: bool = False):
        self.max_iter = max_iter
        self.max_eval = max_eval or max_iter * 1.25
        self.tol_fun, self.tol_x = tol_fun, tol_x
        self.n_correction = n_correction
        self.learning_rate = learning_rate
        self.line_search = line_search

    def optimize(self, feval, x, config: Optional[Table] = None,
                 state: Optional[Table] = None):
        def fe(flat):
            loss, g = feval(_unflat(flat, x))
            return float(loss), _flat(g)

        xf = _flat(x)
        f, g = fe(xf)
        losses = [f]
        n_eval = 1
        old_dirs, old_steps = [], []
        h_diag = 1.0
        prev_g = g
        d = -g
        t = min(1.0, 1.0 / float(g.abs().sum())) * self.learning_rate
        for it in range(self.max_iter):
            if it > 0:
                y = g - prev_g
                s = d * t
                ys = float(torch.dot(y, s))
                if ys > 1e-10:
                    if len(old_dirs) == self.n_correction:
                        old_dirs.pop(0)
                        old_steps.pop(0)
                    old_dirs.append(s)
                    old_steps.append(y)
                    h_diag = ys / float(torch.dot(y, y))
                # the two-loop recursion
                q = -g
                al = []
                ro = [1.0 / float(torch.dot(old_steps[i], old_dirs[i]))
                      for i in range(len(old_dirs))]
                for i in range(len(old_dirs) - 1, -1, -1):
                    a = ro[i] * float(torch.dot(old_dirs[i], q))
                    al.insert(0, a)
                    q = q - a * old_steps[i]
                q = q * h_diag
                for i in range(len(old_dirs)):
                    b = ro[i] * float(torch.dot(old_steps[i], q))
                    q = q + (al[i] - b) * old_dirs[i]
                d = q
                t = self.learning_rate
            prev_g = g
            gtd = float(torch.dot(g, d))
            if gtd > -self.tol_x:
                break
            if self.line_search:
                t, f, g, xf, ls_evals = self._lswolfe(fe, xf, t, d, f, g,
                                                      gtd)
                n_eval += ls_evals
            else:
                xf = xf + t * d
                f, g = fe(xf)
                n_eval += 1
            losses.append(f)
            if n_eval >= self.max_eval:
                break
            if float(g.abs().max()) <= self.tol_fun:
                break
            if abs(losses[-1] - losses[-2]) < self.tol_fun:
                break
        return _unflat(xf, x), losses

    def _lswolfe(self, fe, x, t, d, f, g, gtd, c1=1e-4, c2=0.9, max_ls=25):
        """The strong-Wolfe search along ``d`` from step ``t``: doubling
        until the step brackets a minimum, then bisection.  Returns (step,
        loss, gradient, new x, evaluations)."""
        f0, gtd0 = f, gtd
        evals = 0
        t_prev, f_prev = 0.0, f
        for _ in range(max_ls):
            f_new, g_new = fe(x + t * d)
            evals += 1
            gtd_new = float(torch.dot(g_new, d))
            if f_new > f0 + c1 * t * gtd0 or (evals > 1 and f_new >= f_prev):
                # zoom between t_prev and t
                lo, hi = t_prev, t
                f_lo = f_prev
                for _ in range(max_ls):
                    tm = 0.5 * (lo + hi)
                    fm, gm = fe(x + tm * d)
                    evals += 1
                    gtdm = float(torch.dot(gm, d))
                    if fm > f0 + c1 * tm * gtd0 or fm >= f_lo:
                        hi = tm
                    else:
                        if abs(gtdm) <= -c2 * gtd0:
                            return tm, fm, gm, x + tm * d, evals
                        if gtdm * (hi - lo) >= 0:
                            hi = lo
                        lo, f_lo = tm, fm
                    if abs(hi - lo) < 1e-9:
                        return tm, fm, gm, x + tm * d, evals
                return tm, fm, gm, x + tm * d, evals
            if abs(gtd_new) <= -c2 * gtd0:
                return t, f_new, g_new, x + t * d, evals
            if gtd_new >= 0:
                return self._zoom_simple(fe, x, d, t, t_prev, f0, gtd0, c1,
                                         c2, evals)
            t_prev, f_prev = t, f_new
            t = t * 2.0
        return t, f_new, g_new, x + t * d, evals

    def _zoom_simple(self, fe, x, d, lo, hi, f0, gtd0, c1, c2, evals,
                     max_ls=25):
        for _ in range(max_ls):
            tm = 0.5 * (lo + hi)
            fm, gm = fe(x + tm * d)
            evals += 1
            gtdm = float(torch.dot(gm, d))
            if fm > f0 + c1 * tm * gtd0:
                hi = tm
            else:
                if abs(gtdm) <= -c2 * gtd0:
                    break
                lo = tm
            if abs(hi - lo) < 1e-9:
                break
        return tm, fm, gm, x + tm * d, evals
