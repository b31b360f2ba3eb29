"""Deterministic host-side RNG, Torch7's MT19937
(``bigdl_tpu/utils/random_generator.py``, the part the data feed draws
from).

Parity: ``utils/RandomGenerator.scala:24-266``: the Matsumoto-Nishimura
MT19937 with Torch7's seeding and tempering, ``uniform`` on [a, b) from one
32-bit draw, and the Fisher-Yates ``shuffle`` that ``load_in_data`` splits
a corpus with.  The same seed gives the same stream as the reference's, so
both packages split a corpus the same way.  Each thread has its own
generator (:func:`RNG`), seeded from ``os.urandom`` unless set.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UMASK = 0x80000000
_LMASK = 0x7FFFFFFF
_MASK32 = 0xFFFFFFFF


class RandomGenerator:

    def __init__(self):
        self._state = [0] * _N
        self._next = 0
        self._left = 1
        self.set_seed(self._random_seed())

    @staticmethod
    def _random_seed() -> int:
        try:
            return int.from_bytes(os.urandom(8), "big")
        except NotImplementedError:
            return time.time_ns()

    def set_seed(self, seed: int) -> "RandomGenerator":
        s = self._state
        s[0] = seed & _MASK32
        for i in range(1, _N):
            s[i] = (1812433253 * (s[i - 1] ^ (s[i - 1] >> 30)) + i) & _MASK32
        self._next = 0
        self._left = 1
        return self

    def _next_state(self) -> None:
        s = np.asarray(self._state, np.uint32)
        nxt = np.concatenate([s[1:], s[:1]])
        mixed = (s & _UMASK) | (nxt & _LMASK)
        twisted = (mixed >> np.uint32(1)) ^ np.where(
            nxt & np.uint32(1), np.uint32(_MATRIX_A), np.uint32(0))
        rolled = np.concatenate([s[_M:], s[:_M]])
        self._state = (rolled ^ twisted).tolist()
        self._left = _N
        self._next = 0

    def _random(self) -> int:
        """Uniform integer on [0, 0xffffffff] (tempered MT output)."""
        self._left -= 1
        if self._left == 0:
            self._next_state()
        y = self._state[self._next]
        self._next += 1
        y ^= y >> 11
        y = (y ^ ((y << 7) & 0x9D2C5680)) & _MASK32
        y = (y ^ ((y << 15) & 0xEFC60000)) & _MASK32
        y ^= y >> 18
        return y

    def uniform(self, a: float, b: float) -> float:
        """Uniform on [a, b)."""
        return self._random() * (1.0 / 4294967296.0) * (b - a) + a

    def shuffle_indices(self, n: int) -> np.ndarray:
        """Fisher-Yates permutation of range(n) from this stream."""
        perm = list(range(n))
        for i in range(n):
            j = int(self.uniform(0, n - i)) + i
            perm[i], perm[j] = perm[j], perm[i]
        return np.asarray(perm, np.int64)


_thread_local = threading.local()


def RNG() -> RandomGenerator:
    """This thread's generator (``RandomGenerator.RNG``)."""
    rng = getattr(_thread_local, "rng", None)
    if rng is None:
        rng = RandomGenerator()
        _thread_local.rng = rng
    return rng


def shuffle(data):
    """In-place Fisher-Yates with this thread's generator
    (``RandomGenerator.shuffle``)."""
    perm = RNG().shuffle_indices(len(data))
    snapshot = list(data)
    for i, j in enumerate(perm):
        data[i] = snapshot[j]
    return data
