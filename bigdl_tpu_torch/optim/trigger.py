"""Triggers (``bigdl_tpu/optim/trigger.py``, a host-only copy): predicates
over optimizer state that drive validation, checkpoints and termination.
Parity: ``optim/Trigger.scala:21-72``."""

from __future__ import annotations

from bigdl_tpu_torch.utils.table import Table


class Trigger:
    def __call__(self, state: Table) -> bool:
        raise NotImplementedError

    @staticmethod
    def every_epoch():
        return _EveryEpoch()

    @staticmethod
    def several_iteration(interval: int):
        return _SeveralIteration(interval)

    @staticmethod
    def max_epoch(max_: int):
        return _MaxEpoch(max_)

    @staticmethod
    def max_iteration(max_: int):
        return _MaxIteration(max_)

    @staticmethod
    def and_(*triggers: "Trigger"):
        return _And(triggers)

    @staticmethod
    def or_(*triggers: "Trigger"):
        return _Or(triggers)


class _EveryEpoch(Trigger):
    """Fires when the epoch counter moves past the last fired epoch."""

    def __init__(self):
        self.last = 0

    def __call__(self, state):
        epoch = state.get("epoch", 1)
        if state.get("isLastBatchOfEpoch", False) or \
                (self.last and epoch > self.last):
            self.last = epoch
            return True
        self.last = self.last or epoch
        return False


class _SeveralIteration(Trigger):
    def __init__(self, interval: int):
        self.interval = interval

    def __call__(self, state):
        it = state.get("neval", 0)
        return it > 0 and it % self.interval == 0


class _MaxEpoch(Trigger):
    def __init__(self, max_: int):
        self.max = max_

    def __call__(self, state):
        return state.get("epoch", 1) > self.max


class _MaxIteration(Trigger):
    def __init__(self, max_: int):
        self.max = max_

    def __call__(self, state):
        return state.get("neval", 0) >= self.max


class _And(Trigger):
    def __init__(self, ts):
        self.ts = ts

    def __call__(self, state):
        return all(t(state) for t in self.ts)


class _Or(Trigger):
    def __init__(self, ts):
        self.ts = ts

    def __call__(self, state):
        return any(t(state) for t in self.ts)
