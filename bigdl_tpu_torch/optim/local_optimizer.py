"""Single-host trainer (``bigdl_tpu/optim/local_optimizer.py``).

Parity: ``optim/LocalOptimizer.scala:40-244``.  A step is one eager
forward, backward and optimizer update on the trainer's device
(``device=``, CUDA by default, never a silent CPU fallback); ``float(loss)``
is its only host sync, as in the reference.  The host keeps what the
reference's driver loop kept: the data iterator, the epoch and iteration
counters, the learning-rate schedule, triggers, validation and the
per-step log line.  A batch's arrays are copied to the device, or used
where they lie when they are already tensors there (``PrefetchToDevice``'s
batches).

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

Observability (``bigdl_tpu_torch.observability``): with the run ledger on
(``BIGDL_TPU_RUN_DIR`` or ``set_run_dir``) a run writes ``run.start`` and
``run.end``, one ``step`` record a step, the reference's spans (``init``,
``data.next``, ``h2d``, ``train.step``, ``cost.analysis`` once,
``loop.bookkeeping``, ``validate``, ``checkpoint.save``), ``mem.hbm``
samples of a CUDA device, the first step's ``cost.analysis`` record and
``step.skipped`` events, and dumps its ``Metrics`` as Prometheus text at
run end.  ``train.step`` closes after ``float(loss)``, the step's one host
sync, so on the card it spans the step's device time; ``h2d`` spans the
enqueue of the copies.  The records add no synchronisation.
``set_step_timeout`` (or ``BIGDL_TPU_STEP_TIMEOUT``) arms a
:class:`~bigdl_tpu_torch.resilience.watchdog.Watchdog` over ``train.step``;
``set_train_summary``/``set_val_summary`` tee the scalars into TensorBoard
files and the ledger.  ``step_records`` keeps the step records in memory
too.

Fault sites (``resilience/fault_injector.py``): ``grad.nan`` at step N
poisons that step's batch inside its ``train.step`` span, as
``jnp.full_like(data, jnp.nan)`` does in the reference (:func:`nan_like`),
so the non-finite guard must skip the update; ``train.step`` at N raises
after step N-1's validation and snapshot, the preemption that a relaunch
with ``auto_resume`` recovers from.
"""

from __future__ import annotations

import logging
import math
import os
import re
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.convert import export_params
from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import tree_leaves
from bigdl_tpu_torch.core.precision import mixed_forward
from bigdl_tpu_torch.observability import costs
from bigdl_tpu_torch.observability import ledger as run_ledger
from bigdl_tpu_torch.observability import tracer
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, Default, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import ValidationMethod
from bigdl_tpu_torch.resilience.fault_injector import FaultInjector
from bigdl_tpu_torch.resilience.watchdog import Watchdog
from bigdl_tpu_torch.utils.file import File, load_model_snapshot
from bigdl_tpu_torch.utils.table import T, Table

logger = logging.getLogger("bigdl_tpu_torch.optim")

# counter of steps the non-finite guard skipped (the reference's
# dropped-gradient accounting, DistriOptimizer.scala:244-272)
SKIPPED_STEPS = "skipped steps (non-finite)"


def _default_step_timeout() -> Optional[float]:
    """Watchdog timeout from ``BIGDL_TPU_STEP_TIMEOUT`` (seconds; unset/0
    disarms).  Per-optimizer override via ``set_step_timeout``."""
    raw = os.environ.get("BIGDL_TPU_STEP_TIMEOUT", "")
    try:
        t = float(raw) if raw else 0.0
    except ValueError:
        raise ValueError(
            f"BIGDL_TPU_STEP_TIMEOUT={raw!r} is not a number of seconds")
    return t if t > 0 else None


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
    """A batch array as a tensor on ``device``: a tensor (a batch that
    ``PrefetchToDevice`` or ``StagingRing`` already put on the card) is used
    as it is where it lies there; a host array is copied."""
    if isinstance(array, torch.Tensor):
        return array.to(device)
    return torch.from_numpy(np.asarray(array)).to(device)


def nan_like(data: torch.Tensor) -> torch.Tensor:
    """The reference's poisoned batch, ``jnp.full_like(data, jnp.nan)``:
    NaN in a floating batch; the cast of NaN elsewhere, 0 in an integer
    batch (token ids) and True in a boolean one."""
    if data.is_floating_point():
        return torch.full_like(data, math.nan)
    if data.dtype == torch.bool:
        return torch.ones_like(data)
    return torch.zeros_like(data)


def _f32_input(data: torch.Tensor) -> torch.Tensor:
    """A float32 model's input: floating data in a narrower dtype (a batch
    cast to bf16 on the host) computes in float32, as jnp promotes it."""
    if data.is_floating_point() and data.dtype != torch.float32:
        return data.float()
    return data


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
        self.metrics = Metrics()
        self.train_summary = None        # TrainSummary facade (optional)
        self.val_summary = None          # ValidationSummary facade
        self.step_timeout = _default_step_timeout()
        self.mixed_precision = False
        self.skip_nonfinite = True
        self.seed = 0
        self._generator: Optional[torch.Generator] = None
        self.opt_state = None
        # the step records of this trainer's runs, kept in memory beside
        # the ledger's
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
        """Arm the step watchdog: a step (up to its host sync) exceeding
        ``seconds`` fails fast with a stack dump and a
        ``WatchdogTimeout`` instead of hanging the run.  ``None``/0
        disarms.  Default from ``BIGDL_TPU_STEP_TIMEOUT``."""
        self.step_timeout = seconds
        return self

    def set_train_summary(self, summary):
        """Tee per-step scalars (``Loss``, ``Throughput``,
        ``LearningRate``) into a ``TrainSummary``: TensorBoard event files
        and the run ledger.  Per-tag cadence via
        ``summary.set_summary_trigger``."""
        self.train_summary = summary
        return self

    def set_val_summary(self, summary):
        """Tee validation results into a ``ValidationSummary``, one tag
        per method."""
        self.val_summary = summary
        return self

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
            y = self.model(_f32_input(data))
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
        self.metrics.incr(SKIPPED_STEPS)
        run_ledger.emit("event", kind="step.skipped",
                        step=self.state["neval"], total=skipped)
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
        with tracer.span("checkpoint.save", step=neval):
            File.save({"params": export_params(self.model),
                       "model_state": self.model.state_tree()},
                      f"{self.checkpoint_path}/model{suffix}", True)
            # the state file is written last: it commits the pair
            File.save({"state": dict(self.state),
                       "opt_state": self.opt_state,
                       "rng": self._generator.get_state()},
                      f"{self.checkpoint_path}/state{suffix}", True)

    # -- observability (run ledger + summaries) ------------------------------

    def _run_start(self) -> None:
        """Open the run in the ledger when it is on; free otherwise."""
        if not run_ledger.enabled():
            return
        tracer.reset_stack()     # a prior failed run must not parent us
        cuda = self.device.type == "cuda"
        run_ledger.emit(
            "run.start", kind=type(self).__name__, pid=os.getpid(),
            thread=threading.get_ident(),
            trace=run_ledger.trace_id(),
            process_index=0, process_count=1,
            device_count=torch.cuda.device_count() if cuda else 1,
            platform="gpu" if cuda else self.device.type,
            start_step=self.state.get("neval", 0),
            start_epoch=self.state.get("epoch", 1))

    def _run_end(self, wall_s: float) -> None:
        """Close the run record, dump the Metrics counters as Prometheus
        text next to the ledger, and flush, so the files are complete the
        moment ``optimize()`` returns."""
        led = run_ledger.get_ledger()
        if led is None:
            return
        run_ledger.emit("run.end", kind=type(self).__name__,
                        pid=os.getpid(), wall_s=wall_s,
                        steps=self.state["neval"],
                        epoch=self.state["epoch"],
                        skipped=self.state.get("skippedSteps", 0))
        from bigdl_tpu_torch.observability.prometheus import \
            write_prometheus
        write_prometheus(self.metrics,
                         os.path.join(led.dir,
                                      f"metrics-{os.getpid()}.prom"))
        led.flush()

    def _emit_step_record(self, stepno: int, loss: float, records: int,
                          dur_s: float, clr: float) -> None:
        """One ``step`` record (the ledger's, and ``step_records``'), and
        the train summary's scalars.  A non-finite loss is null in the
        ledger: a bare NaN or inf would not be strict JSON."""
        self.step_records.append({"step": stepno,
                                  "epoch": self.state["epoch"],
                                  "loss": loss, "records": records,
                                  "dur_s": dur_s})
        finite = math.isfinite(loss)
        run_ledger.emit("step", step=stepno, epoch=self.state["epoch"],
                        loss=loss if finite else None, records=records,
                        dur_s=dur_s,
                        records_per_s=records / max(dur_s, 1e-9),
                        skipped=math.isnan(loss) and self.skip_nonfinite)
        ts = self.train_summary
        if ts is not None:
            # called after the loop updates neval and isLastBatchOfEpoch,
            # so the triggers read the post-step state the checkpoint and
            # validation triggers read; ``clr`` is the rate the step ran
            # with
            for tag, val in (("Loss", loss),
                             ("Throughput", records / max(dur_s, 1e-9)),
                             ("LearningRate", clr)):
                trig = ts.trigger_for(tag)
                if (trig is None or trig(self.state)) and \
                        math.isfinite(val):
                    ts.add_scalar(tag, val, stepno)

    def _tee_val_scalars(self, results) -> None:
        vs = self.val_summary
        if vs is None or not results:
            return
        for m, r in zip(self.validation_methods, results):
            vs.add_scalar(str(m), float(r.result()[0]),
                          self.state["neval"])

    # -- main loop -----------------------------------------------------------

    def optimize(self):
        self._run_start()
        with tracer.span("init", optimizer=type(self).__name__):
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

            count_this_epoch = self.state.get("recordsProcessedThisEpoch",
                                              0)
            # a resumed run replays the completed epochs' shuffles
            _sync_shuffles(self.dataset, self.state.get("epoch", 1) - 1)
            data_iter = self.dataset.data(train=True)
            ds_size = self.dataset.size()
        wall_start = time.time()
        # a fresh iterator restarts the epoch: skip the records the
        # interrupted run had trained, so the run takes the batches an
        # uninterrupted one would
        records_to_skip = count_this_epoch
        cost_done = False          # one cost.analysis per optimize()
        while not self.end_when(self.state):
            with tracer.span("data.next"):
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
            # a staged feed's batch already lies on the device: the span
            # records that its copy was the feed's (ingest.h2d)
            staged = isinstance(batch.data, torch.Tensor) and \
                batch.data.device.type == self.device.type
            with tracer.span("h2d", staged=staged):
                data = _to_device(batch.data, self.device)
                labels = _to_device(batch.labels, self.device)
            stepno = self.state["neval"]
            t0 = time.time()
            clr = self._current_clr()
            probe = None
            if not cost_done:
                cost_done = True
                # the FLOPs of the real first step: no extra step runs
                probe = costs.cost_probe("train.step", params, data,
                                         labels)
            with tracer.span("train.step", step=stepno), \
                    Watchdog(self.step_timeout,
                             label=f"train step {stepno}"):
                if FaultInjector.should("grad.nan", stepno):
                    # inside the span: the poison is step work
                    data = nan_like(data)
                if probe is None:
                    loss = self._step(params, data, labels, clr, stepno,
                                      state)
                else:
                    with probe:
                        loss = self._step(params, data, labels, clr,
                                          stepno, state)
                loss = float(loss)    # the host sync: the hang point
            dt = time.time() - t0
            if probe is not None:
                with tracer.span("cost.analysis"):
                    costs.emit_cost(probe, kind=type(self).__name__)
            # everything after the step — metrics, ledger and summary
            # bookkeeping, logging, epoch rollover, validation and
            # checkpoint triggers — is span-attributed too
            with tracer.span("loop.bookkeeping"):
                self.metrics.add("computing time average", dt * 1e9)
                costs.sample_hbm(self.device, step=stepno)
                if self.skip_nonfinite and math.isnan(loss):
                    self._record_skipped_step()

                bs = batch.size()
                count_this_epoch += bs
                self.state["neval"] += 1
                self.state["recordsProcessedThisEpoch"] = count_this_epoch
                self.state["isLastBatchOfEpoch"] = \
                    count_this_epoch >= ds_size
                # post-update, pre-rollover: summary triggers see the
                # completed step's counters
                self._emit_step_record(stepno, loss, bs, dt, clr)
                logger.info(
                    "Epoch %d %d/%d loss %.6f throughput %.1f "
                    "records/second", self.state["epoch"],
                    count_this_epoch, ds_size, loss, bs / max(dt, 1e-9))

                if count_this_epoch >= ds_size:
                    self.state["epoch"] += 1
                    count_this_epoch = 0
                    self.state["recordsProcessedThisEpoch"] = 0
                    _sync_shuffles(self.dataset, self.state["epoch"] - 1)
                    data_iter = self.dataset.data(train=True)

                self._maybe_validate()
                self._maybe_checkpoint()
                self.state["isLastBatchOfEpoch"] = False
                # an injected preemption after the snapshot: the crash a
                # relaunch with auto_resume recovers from
                FaultInjector.fire("train.step", step=self.state["neval"])

        wall = time.time() - wall_start
        logger.info("Training finished in %.1fs (%d iterations)",
                    wall, self.state["neval"])
        self._close_ingest()
        self._run_end(wall)
        return self.model

    def _close_ingest(self) -> None:
        """Stop a sharded feed's worker pool at the end of the run
        (``ShardedDataSet`` keeps it across epochs on purpose); a dataset
        without ``close()`` is left as it is.  On a failure path (say
        ``IngestWorkerDied``) the pool has torn itself down already."""
        for ds in (self.dataset, self.validation_dataset):
            close = getattr(ds, "close", None)
            if callable(close):
                close()

    # -- validation -----------------------------------------------------------

    def _maybe_validate(self):
        if not self.validation_trigger or \
                not self.validation_trigger(self.state):
            return None
        return self.validate()

    def validate(self):
        with tracer.span("validate", step=self.state.get("neval", 0)):
            results = _evaluate(self.model, self.validation_dataset,
                                self.validation_methods, self.device)
        if not results:
            logger.warning("validation dataset produced no batches — "
                           "skipping")
            return None
        for m, r in zip(self.validation_methods, results):
            logger.info("%s is %r", m, r)
        self.state["lastValidation"] = results
        self._tee_val_scalars(results)
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
                y = model(_f32_input(_to_device(batch.data, device)))
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
