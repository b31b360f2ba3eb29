"""Deterministic host-side RNG, Torch7's MT19937
(``bigdl_tpu/utils/random_generator.py``).

Parity: ``utils/RandomGenerator.scala:24-266``: the Matsumoto-Nishimura
MT19937 with Torch7's seeding and tempering and Torch's transforms:
``uniform`` on [a, b) from one 32-bit draw, Box-Muller ``normal`` with the
pair cached, inverse-CDF ``exponential``/``cauchy``/``geometric``,
``log_normal``, ``bernoulli``, the array draws and the Fisher-Yates
``shuffle_indices`` that ``load_in_data`` splits a corpus with.  The same
seed gives the same stream as the reference's, so both packages split a
corpus the same way.  Each thread has its own generator (:func:`RNG`),
seeded from ``os.urandom`` unless set.

The state lives in the native host library (``bigdl_tpu_torch.native``,
``bn_mt_*``), where every draw runs; ``force_python=True`` keeps it in
Python, the plain version the native stream is held to bit for bit.
"""

from __future__ import annotations

import math
import os
import threading
import time

import numpy as np

from bigdl_tpu_torch import native as _native

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UMASK = 0x80000000
_LMASK = 0x7FFFFFFF
_MASK32 = 0xFFFFFFFF


class RandomGenerator:
    """MT19937 with Torch7 seeding/tempering and distribution transforms."""

    def __init__(self, seed: int | None = None, force_python: bool = False):
        self._h = None
        self._lib = None if force_python else _native.lib()
        self._state = [0] * _N
        self._seed = 0
        self._next = 0
        self._left = 1
        self._normal_x = 0.0
        self._normal_y = 0.0
        self._normal_rho = 0.0
        self._normal_is_valid = False
        if self._lib is not None:
            self._h = self._lib.bn_mt_new(0)
        self.set_seed(self._random_seed() if seed is None else seed)

    def __del__(self):
        if self._h is not None and self._lib is not None:
            try:
                self._lib.bn_mt_free(self._h)
            except Exception:
                pass
            self._h = None

    # -- seeding -------------------------------------------------------------

    @staticmethod
    def _random_seed() -> int:
        try:
            return int.from_bytes(os.urandom(8), "big")
        except NotImplementedError:
            return time.time_ns()

    def reset(self) -> "RandomGenerator":
        if self._h is not None:
            # Transplant the all-zero state (NOT seed 0, which is a valid
            # MT stream) so both backends expose identical reset semantics.
            self._lib.bn_mt_set_state(
                self._h, np.zeros(_N, np.uint32),
                np.asarray([0, 1, 0, 0], np.int64),
                np.zeros(3, np.float64))
            return self
        self._state = [0] * _N
        self._seed = 0
        self._next = 0
        self._left = 1
        self._normal_x = self._normal_y = self._normal_rho = 0.0
        self._normal_is_valid = False
        return self

    def set_seed(self, seed: int) -> "RandomGenerator":
        if self._h is not None:
            self._lib.bn_mt_set_seed(self._h, seed & ((1 << 64) - 1))
            return self
        self.reset()
        self._seed = seed
        s = self._state
        s[0] = seed & _MASK32
        for i in range(1, _N):
            s[i] = (1812433253 * (s[i - 1] ^ (s[i - 1] >> 30)) + i) & _MASK32
        self._left = 1
        return self

    def get_seed(self) -> int:
        if self._h is not None:
            return int(self._lib.bn_mt_get_seed(self._h))
        return self._seed

    def clone(self) -> "RandomGenerator":
        out = RandomGenerator(0, force_python=self._h is None)
        out.copy(self)
        return out

    def copy(self, other: "RandomGenerator") -> "RandomGenerator":
        if self._h is not None and other._h is not None:
            s, im, dm = other._export_state()
            self._lib.bn_mt_set_state(self._h, s, im, dm)
            return self
        if self._h is not None or other._h is not None:
            # Cross-backend copy goes through the exported state tuple.
            s, im, dm = other._export_state()
            self._import_state(s, im, dm)
            return self
        self._state = list(other._state)
        self._seed = other._seed
        self._next = other._next
        self._left = other._left
        self._normal_x = other._normal_x
        self._normal_y = other._normal_y
        self._normal_rho = other._normal_rho
        self._normal_is_valid = other._normal_is_valid
        return self

    def _export_state(self):
        if self._h is not None:
            s = np.empty(_N, np.uint32)
            im = np.empty(4, np.int64)
            dm = np.empty(3, np.float64)
            self._lib.bn_mt_get_state(self._h, s, im, dm)
            return s, im, dm
        s = np.asarray(self._state, np.uint32)
        im = np.asarray([self._next, self._left,
                         1 if self._normal_is_valid else 0,
                         self._seed & ((1 << 63) - 1)], np.int64)
        dm = np.asarray([self._normal_x, self._normal_y, self._normal_rho],
                        np.float64)
        return s, im, dm

    def _import_state(self, s, im, dm):
        if self._h is not None:
            self._lib.bn_mt_set_state(
                self._h, np.ascontiguousarray(s, np.uint32),
                np.ascontiguousarray(im, np.int64),
                np.ascontiguousarray(dm, np.float64))
            return
        self._state = [int(v) for v in s]
        self._next, self._left = int(im[0]), int(im[1])
        self._normal_is_valid = bool(im[2])
        self._seed = int(im[3])
        self._normal_x, self._normal_y, self._normal_rho = \
            float(dm[0]), float(dm[1]), float(dm[2])

    # -- core generator ------------------------------------------------------

    def _next_state(self) -> None:
        # Vectorised MT19937 reload (the reference's scalar while-loops,
        # ``RandomGenerator.scala:160-187``, collapse to three array steps).
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
        if self._h is not None:
            return int(self._lib.bn_mt_random(self._h))
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

    def _basic_uniform(self) -> float:
        if self._h is not None:
            return self._lib.bn_mt_uniform(self._h, 0.0, 1.0)
        return self._random() * (1.0 / 4294967296.0)

    # -- distributions (Torch semantics) -------------------------------------

    def uniform(self, a: float, b: float) -> float:
        """Uniform on [a, b)."""
        if self._h is not None:
            return self._lib.bn_mt_uniform(self._h, a, b)
        return self._basic_uniform() * (b - a) + a

    def normal(self, mean: float, stdv: float) -> float:
        if stdv <= 0:
            raise ValueError("standard deviation must be strictly positive")
        if self._h is not None:
            return self._lib.bn_mt_normal(self._h, mean, stdv)
        # Box–Muller with the cos/sin pair cached across calls.
        if not self._normal_is_valid:
            self._normal_x = self._basic_uniform()
            self._normal_y = self._basic_uniform()
            self._normal_rho = math.sqrt(-2 * math.log(1.0 - self._normal_y))
            self._normal_is_valid = True
            return (self._normal_rho * math.cos(2 * math.pi * self._normal_x)
                    * stdv + mean)
        self._normal_is_valid = False
        return (self._normal_rho * math.sin(2 * math.pi * self._normal_x)
                * stdv + mean)

    def exponential(self, lam: float) -> float:
        if self._h is not None:
            return self._lib.bn_mt_exponential(self._h, lam)
        return -1.0 / lam * math.log(1 - self._basic_uniform())

    def cauchy(self, median: float, sigma: float) -> float:
        if self._h is not None:
            return self._lib.bn_mt_cauchy(self._h, median, sigma)
        return median + sigma * math.tan(math.pi * (self._basic_uniform() - 0.5))

    def log_normal(self, mean: float, stdv: float) -> float:
        if stdv <= 0:
            raise ValueError("standard deviation must be strictly positive")
        zm = mean * mean
        zs = stdv * stdv
        return math.exp(self.normal(math.log(zm / math.sqrt(zs + zm)),
                                    math.sqrt(math.log(zs / zm + 1))))

    def geometric(self, p: float) -> int:
        # Strict bounds (Torch's THRandom_geometric contract): p == 1 would
        # divide by log(1) = 0, p == 0 never terminates.
        if not 0 < p < 1:
            raise ValueError("must be > 0 and < 1")
        if self._h is not None:
            return int(self._lib.bn_mt_geometric(self._h, p))
        return int(math.log(1 - self._basic_uniform()) / math.log(p) + 1)

    def bernoulli(self, p: float) -> bool:
        if not 0 <= p <= 1:
            raise ValueError("must be >= 0 and <= 1")
        if self._h is not None:
            return bool(self._lib.bn_mt_bernoulli(self._h, p))
        return self._basic_uniform() <= p

    # -- batch draws (native-accelerated; Python fallback loops) -------------

    def uniform_array(self, a: float, b: float, n: int) -> np.ndarray:
        if self._h is not None:
            out = np.empty(n, np.float64)
            self._lib.bn_mt_uniform_array(self._h, a, b, n, out)
            return out
        return np.asarray([self.uniform(a, b) for _ in range(n)])

    def normal_array(self, mean: float, stdv: float, n: int) -> np.ndarray:
        if stdv <= 0:
            raise ValueError("standard deviation must be strictly positive")
        if self._h is not None:
            out = np.empty(n, np.float64)
            self._lib.bn_mt_normal_array(self._h, mean, stdv, n, out)
            return out
        return np.asarray([self.normal(mean, stdv) for _ in range(n)])

    def shuffle_indices(self, n: int) -> np.ndarray:
        """Fisher–Yates permutation of range(n) from this stream."""
        if self._h is not None:
            out = np.empty(n, np.int64)
            self._lib.bn_mt_shuffle_indices(self._h, n, out)
            return out
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
