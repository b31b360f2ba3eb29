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

File snapshots (``set_checkpoint``): on its trigger, after validation, the
trainer writes ``model.<neval>`` (the JAX package's params pytree and
module state, one format in both packages) and then ``state.<neval>``
(the progress Table, the optimizer state as host numpy arrays, the
generator's state), the state file last: it is the pair's commit marker.
A resumed run (``resume_from``, ``auto_resume`` or ``set_state`` with a
state snapshot) replays the completed epochs' shuffles and skips the
records the interrupted epoch had trained, so it takes exactly the batches,
the updates and the dropout masks of an uninterrupted run.  A generator
state of another device type (a snapshot taken on the card, resumed on the
CPU) cannot be restored: that run keeps the batches and the updates, and
its draws restart from the seed.
"""

from __future__ import annotations

import collections
import logging
import math
import os
import re
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.convert import export_params
from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import tree_leaves
from bigdl_tpu_torch.core.precision import mixed_forward
from bigdl_tpu_torch.optim.optim_method import SGD, Default, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import ValidationMethod
from bigdl_tpu_torch.utils.file import File, load_model_snapshot
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
        self.checkpoint_trigger: Optional[Trigger] = None
        self.checkpoint_path: Optional[str] = None
        # the reference's default: one model.<neval> snapshot per trigger;
        # overwrite_checkpoint_() opts in to one overwritten pair
        self.overwrite_checkpoint = False
        self.auto_resume = False         # restore the latest snapshot first
        self._resume_path: Optional[str] = None   # resume_from
        self._resume_opt_state = None    # from a state snapshot
        self._resume_rng = None
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
        """Restore optimizer progress from a bare state Table or from a
        ``state.<neval>`` snapshot (``{"state", "opt_state", "rng"}``),
        whose optimizer state and generator state the next ``optimize()``
        takes up."""
        if isinstance(state, dict) and "state" in state \
                and "opt_state" in state:
            self._resume_opt_state = state["opt_state"]
            self._resume_rng = state.get("rng")
            state = state["state"]
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
        """File snapshots under ``path`` on ``trigger``.  With
        ``auto_resume`` a relaunched run first restores the latest snapshot
        found there, or starts fresh when there is none."""
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        self.auto_resume = auto_resume
        return self

    def resume_from(self, path: str):
        """Resume from the latest complete snapshot pair under ``path`` at
        ``optimize()``, which raises ``FileNotFoundError`` when there is
        none: an explicit resume must not quietly train a fresh model."""
        self._resume_path = path
        return self

    def overwrite_checkpoint_(self):
        """Write one ``model``/``state`` pair, overwritten at each trigger,
        in place of one pair per trigger."""
        self.overwrite_checkpoint = True
        return self

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

    def _step(self, params, data, labels, clr: float, stepno: int,
              state=()) -> torch.Tensor:
        """Forward, backward and update in place; returns the loss on the
        device, NaN when the guard kept the previous weights and the
        previous module ``state`` (the running statistics a training
        forward moves in place)."""
        if self.skip_nonfinite:
            old_state = [b.clone() for b in state]
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
                for b, o in zip(state, old_state):
                    b.copy_(torch.where(ok, b, o))
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

    # -- resume (File snapshots) ---------------------------------------------

    @staticmethod
    def _latest_file_snapshot(path: str) -> Optional[str]:
        """Suffix of the newest complete snapshot pair under ``path``:
        ``".<n>"`` for the largest numbered pair, ``""`` for the overwrite
        pair, None when there is neither.  Both files must be there: a
        crash between the two writes leaves a torn pair, never resumed."""
        if not os.path.isdir(path):
            return None
        names = set(os.listdir(path))
        steps = [int(m.group(1)) for m in
                 (re.fullmatch(r"state\.(\d+)", f) for f in names) if m]
        good = [s for s in sorted(steps, reverse=True)
                if f"model.{s}" in names]
        if good:
            return f".{good[0]}"
        if "state" in names and "model" in names:
            return ""
        return None

    def _maybe_resume(self):
        """Restore the latest complete snapshot when ``resume_from`` asked
        for one (none raises) or ``auto_resume`` is on (none starts
        fresh)."""
        path = self._resume_path or \
            (self.checkpoint_path if self.auto_resume else None)
        if not path:
            return
        suffix = self._latest_file_snapshot(path)
        if suffix is None:
            if self._resume_path is not None:
                raise FileNotFoundError(
                    f"resume_from({path!r}): no complete model/state "
                    "snapshot pair found")
            logger.info("auto_resume: no snapshot under %s — fresh start",
                        path)
            return
        load_model_snapshot(self.model, f"{path}/model{suffix}")
        self.set_state(File.load(f"{path}/state{suffix}"))
        logger.info("resumed File snapshot %s/{model,state}%s "
                    "(epoch %d, neval %d)", path, suffix or " (overwrite)",
                    self.state["epoch"], self.state["neval"])

    def _restore_generator(self):
        rng, self._resume_rng = self._resume_rng, None
        if rng is None:
            return
        rng = torch.from_numpy(np.asarray(rng, dtype=np.uint8))
        if rng.numel() != self._generator.get_state().numel():
            logger.warning(
                "the snapshot's generator state is another device type's: "
                "training-mode draws restart from seed %d", self.seed)
            return
        self._generator.set_state(rng)

    def _maybe_checkpoint(self):
        if not self.checkpoint_trigger or not self.checkpoint_path or \
                not self.checkpoint_trigger(self.state):
            return
        neval = self.state["neval"]
        suffix = "" if self.overwrite_checkpoint else f".{neval}"
        File.save({"params": export_params(self.model),
                   "model_state": self.model.state_tree()},
                  f"{self.checkpoint_path}/model{suffix}", True)
        # the state file is written last: it commits the pair
        File.save({"state": dict(self.state), "opt_state": self.opt_state,
                   "rng": self._generator.get_state()},
                  f"{self.checkpoint_path}/state{suffix}", True)

    # -- main loop -----------------------------------------------------------

    def optimize(self):
        self._maybe_resume()
        model = self.model.to(self.device).training_()
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(self.seed)
        self._restore_generator()
        model.set_generator(self._generator)
        params = list(model.param_leaves())
        state = list(model.state_leaves())
        if self._resume_opt_state is not None:
            self.opt_state = {
                k: [_to_device(a, self.device) for a in tree_leaves(v)]
                for k, v in self._resume_opt_state.items()}
            self._resume_opt_state = None
        else:
            self.opt_state = self.optim_method.init_state(
                [p.detach() for p in params])

        count_this_epoch = self.state.get("recordsProcessedThisEpoch", 0)
        # a resumed run replays the completed epochs' shuffles
        _sync_shuffles(self.dataset, self.state.get("epoch", 1) - 1)
        data_iter = self.dataset.data(train=True)
        ds_size = self.dataset.size()
        wall_start = time.time()
        # a fresh iterator restarts the epoch: skip the records the
        # interrupted run had trained, so the run takes the batches an
        # uninterrupted one would
        records_to_skip = count_this_epoch
        while not self.end_when(self.state):
            batch = next(data_iter)
            if records_to_skip >= batch.size():
                records_to_skip -= batch.size()
                continue
            if records_to_skip > 0:
                raise ValueError(
                    f"resume skip remainder {records_to_skip} is smaller "
                    f"than the batch ({batch.size()}): the batch size "
                    "changed since the snapshot; resume with the same "
                    "batching to keep the exact-resume contract")
            stepno = self.state["neval"]
            t0 = time.time()
            data = _to_device(batch.data, self.device)
            labels = _to_device(batch.labels, self.device)
            clr = self._current_clr()
            loss = float(self._step(params, data, labels, clr, stepno,
                                    state))
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
            self._maybe_checkpoint()
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
    float32 forward per batch under ``inference_mode`` (BatchNorm reads its
    running statistics and moves none), the model's mode restored after.
    An empty dataset returns []."""
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
