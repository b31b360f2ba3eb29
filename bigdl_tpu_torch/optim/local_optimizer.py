"""Single-host trainer (``bigdl_tpu/optim/local_optimizer.py``).

Parity: ``optim/LocalOptimizer.scala:40-244``.  A step is one eager
forward, backward and optimizer update on the trainer's device
(``device=``, CUDA by default, never a silent CPU fallback); ``float(loss)``
is its only host sync, as in the reference.  The host keeps what the
reference's driver loop kept: the data iterator, the epoch and iteration
counters, the learning-rate schedule, triggers, validation and the
per-step log line.

Random draws in training (``Dropout``) come from one ``torch.Generator`` on
the device, seeded by :meth:`LocalOptimizer.set_seed` and handed to the
model with ``Module.set_generator``.
"""

from __future__ import annotations

import collections
import logging
import math
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.precision import mixed_forward
from bigdl_tpu_torch.optim.optim_method import SGD, Default, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import ValidationMethod
from bigdl_tpu_torch.utils.table import T, Table

logger = logging.getLogger("bigdl_tpu_torch.optim")

# counter of steps the non-finite guard skipped (the reference's
# dropped-gradient accounting, DistriOptimizer.scala:244-272)
SKIPPED_STEPS = "skipped steps (non-finite)"


def _base_dataset(dataset):
    """The dataset under a chain of transformer wrappers: the one that owns
    the shuffle stream."""
    base = dataset
    while hasattr(base, "base"):
        base = base.base
    return base


def _sync_shuffles(dataset, epochs_completed: int) -> None:
    """Bring the dataset's shuffle stream to ``epochs_completed`` shuffles
    in all; a dataset already driven by an earlier ``optimize()`` is left
    as it is."""
    base = _base_dataset(dataset)
    done = getattr(base, "_shuffles_done", 0)
    while done < epochs_completed:
        dataset.shuffle()
        done += 1
    base._shuffles_done = done


def _later(what: str, slice_name: str):
    raise NotImplementedError(
        f"{what} comes with the {slice_name} slice of the port")


def _to_device(array, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(array)).to(device)


class LocalOptimizer:

    def __init__(self, model, criterion, dataset,
                 end_when: Optional[Trigger] = None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.criterion = criterion
        self.dataset = dataset
        self.end_when = end_when or Trigger.max_epoch(1)
        self.optim_method: OptimMethod = SGD()
        self.config = T()
        self.state = T(epoch=1, neval=0)
        self.validation_trigger: Optional[Trigger] = None
        self.validation_dataset = None
        self.validation_methods: List[ValidationMethod] = []
        self.metrics = collections.Counter()
        self.mixed_precision = False
        self.skip_nonfinite = True
        self.seed = 0
        self._generator: Optional[torch.Generator] = None
        self.opt_state = None
        # one record per step: what the reference writes to its run ledger
        self.step_records: List[dict] = []

    # -- builder API (Optimizer.scala parity) -------------------------------

    def set_optim_method(self, method: OptimMethod):
        self.optim_method = method
        return self

    def set_config(self, config: Table):
        self.config.update_(config)
        return self

    def set_state(self, state: Table):
        """Restore optimizer progress from a bare state Table."""
        if isinstance(state, dict) and "state" in state \
                and "opt_state" in state:
            _later("restoring a state snapshot", "checkpoint")
        self.state.update_(state)
        return self

    def set_end_when(self, trigger: Trigger):
        self.end_when = trigger
        return self

    def set_validation(self, trigger: Trigger, dataset,
                       methods: Sequence[ValidationMethod]):
        self.validation_trigger = trigger
        self.validation_dataset = dataset
        self.validation_methods = list(methods)
        return self

    def set_skip_nonfinite(self, enabled: bool = True):
        """Toggle the non-finite guard (on by default): a step with a NaN or
        inf loss or gradient keeps the previous weights and optimizer state
        and is counted under ``skipped steps (non-finite)``."""
        self.skip_nonfinite = enabled
        return self

    def set_mixed_precision(self, enabled: bool = True):
        """bf16 compute over f32 master weights (``core/precision.py``)."""
        self.mixed_precision = enabled
        return self

    def set_seed(self, seed: int):
        """Seed the device generator of training-mode random draws."""
        self.seed = seed
        self._generator = None
        return self

    def set_checkpoint(self, path: str, trigger: Trigger,
                       auto_resume: bool = False):
        _later("set_checkpoint", "checkpoint")

    def resume_from(self, path: str):
        _later("resume_from", "checkpoint")

    def overwrite_checkpoint_(self):
        _later("overwrite_checkpoint_", "checkpoint")

    def set_mesh(self, mesh, partition_rules=None):
        _later("set_mesh", "parallel-strategies")

    def set_step_timeout(self, seconds: Optional[float]):
        _later("set_step_timeout (the step watchdog)", "host-subsystems")

    def set_train_summary(self, summary):
        _later("set_train_summary", "host-subsystems")

    def set_val_summary(self, summary):
        _later("set_val_summary", "host-subsystems")

    # -- the step -------------------------------------------------------------

    def _current_clr(self) -> float:
        """The schedule's rate for this step, evaluated on the host."""
        sched = getattr(self.optim_method, "schedule", None) or Default()
        cfg = getattr(self.optim_method, "defaults", T()).clone()
        cfg.update_(self.config)
        st = T(evalCounter=self.state.get("neval", 0),
               epoch=self.state.get("epoch", 1))
        return float(sched.current_rate(cfg, st))

    def _step(self, params, data, labels, clr: float,
              stepno: int) -> torch.Tensor:
        """Forward, backward and update in place; returns the loss on the
        device, NaN when the guard kept the previous weights."""
        if self.mixed_precision:
            y = mixed_forward(self.model, data)
        else:
            y = self.model(data)
        loss = self.criterion(y, labels)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            cfg = self.config.clone()
            cfg["clr"] = clr
            old = [p.detach() for p in params]
            new, opt_state = self.optim_method.update(
                list(grads), old, self.opt_state, cfg, stepno)
            if self.skip_nonfinite:
                # a non-finite step must poison neither the weights nor the
                # optimizer state (one NaN in a velocity spoils every later
                # step); a NaN loss is the host's skip signal
                ok = torch.isfinite(loss)
                for g in grads:
                    ok = ok & torch.isfinite(g).all()
                new = [torch.where(ok, a, b) for a, b in zip(new, old)]
                opt_state = {k: [a if a is b else torch.where(ok, a, b)
                                 for a, b in zip(v, self.opt_state[k])]
                             for k, v in opt_state.items()}
                loss = torch.where(ok, loss, torch.full_like(loss, math.nan))
            for p, a in zip(old, new):
                p.copy_(a)
            self.opt_state = opt_state
        return loss.detach()

    def _record_skipped_step(self) -> int:
        skipped = self.state.get("skippedSteps", 0) + 1
        self.state["skippedSteps"] = skipped
        self.metrics[SKIPPED_STEPS] += 1
        logger.warning(
            "step %d: non-finite loss/gradient — update skipped, weights "
            "kept (%d skipped so far)", self.state["neval"], skipped)
        return skipped

    # -- main loop -----------------------------------------------------------

    def optimize(self):
        model = self.model.to(self.device).training_()
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(self.seed)
        model.set_generator(self._generator)
        params = list(model.param_leaves())
        self.opt_state = self.optim_method.init_state(
            [p.detach() for p in params])

        count_this_epoch = self.state.get("recordsProcessedThisEpoch", 0)
        _sync_shuffles(self.dataset, self.state.get("epoch", 1) - 1)
        data_iter = self.dataset.data(train=True)
        ds_size = self.dataset.size()
        wall_start = time.time()
        while not self.end_when(self.state):
            batch = next(data_iter)
            stepno = self.state["neval"]
            t0 = time.time()
            data = _to_device(batch.data, self.device)
            labels = _to_device(batch.labels, self.device)
            clr = self._current_clr()
            loss = float(self._step(params, data, labels, clr, stepno))
            dt = time.time() - t0
            if self.skip_nonfinite and math.isnan(loss):
                self._record_skipped_step()

            bs = batch.size()
            count_this_epoch += bs
            self.state["neval"] += 1
            self.state["recordsProcessedThisEpoch"] = count_this_epoch
            self.state["isLastBatchOfEpoch"] = count_this_epoch >= ds_size
            self.step_records.append({"step": stepno,
                                      "epoch": self.state["epoch"],
                                      "loss": loss, "records": bs,
                                      "dur_s": dt})
            logger.info(
                "Epoch %d %d/%d loss %.6f throughput %.1f records/second",
                self.state["epoch"], count_this_epoch, ds_size, loss,
                bs / max(dt, 1e-9))

            if count_this_epoch >= ds_size:
                self.state["epoch"] += 1
                count_this_epoch = 0
                self.state["recordsProcessedThisEpoch"] = 0
                _sync_shuffles(self.dataset, self.state["epoch"] - 1)
                data_iter = self.dataset.data(train=True)

            self._maybe_validate()
            self.state["isLastBatchOfEpoch"] = False

        logger.info("Training finished in %.1fs (%d iterations)",
                    time.time() - wall_start, self.state["neval"])
        return self.model

    # -- validation -----------------------------------------------------------

    def _maybe_validate(self):
        if not self.validation_trigger or \
                not self.validation_trigger(self.state):
            return None
        return self.validate()

    def validate(self):
        results = _evaluate(self.model, self.validation_dataset,
                            self.validation_methods, self.device)
        if not results:
            logger.warning("validation dataset produced no batches — "
                           "skipping")
            return None
        for m, r in zip(self.validation_methods, results):
            logger.info("%s is %r", m, r)
        self.state["lastValidation"] = results
        return results


def _evaluate(model, dataset, methods, device):
    """Shared evaluation loop (``optim/Validator.scala`` role): an eval-mode
    float32 forward per batch under ``inference_mode``, the model's mode
    restored after.  An empty dataset returns []."""
    was_training = model.training
    model.evaluate()
    results = None
    try:
        with torch.inference_mode():
            for batch in dataset.data(train=False):
                y = model(_to_device(batch.data, device))
                rs = [m(y, batch.labels) for m in methods]
                results = rs if results is None else \
                    [a + b for a, b in zip(results, rs)]
    finally:
        model.train(was_training)
    return [] if results is None else results


class LocalValidator:
    """Standalone evaluation (``optim/LocalValidator.scala``) on ``device``
    (CUDA by default)."""

    def __init__(self, model, dataset, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.dataset = dataset

    def test(self, methods: Sequence[ValidationMethod]):
        self.model.to(self.device)
        return _evaluate(self.model, self.dataset, list(methods),
                         self.device)


Validator = LocalValidator
