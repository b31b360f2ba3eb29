"""Torch-style Table (``bigdl_tpu/utils/table.py``, a host-only copy).

Parity with ``utils/Table.scala:11-325``.

A heterogeneous map with special handling of a contiguous 1-based integer key
prefix (Lua array part).  Used for optimizer config/state and as the Table
side of the Activity union (lists of tensors).  ``T(...)`` is the construction
shorthand the reference exposes.
"""

from __future__ import annotations

from typing import Any, Iterator


class Table(dict):

    def insert(self, value: Any = None, index: int = None) -> "Table":
        """Append to the integer array part (1-based), or insert at index."""
        if index is None:
            self[self.length() + 1] = value
        else:
            n = self.length()
            for i in range(n, index - 1, -1):
                self[i + 1] = self[i]
            self[index] = value
        return self

    def remove(self, index: int = None):
        n = self.length()
        if n == 0 and index is None:
            return None
        if index is None:
            index = n
        if index not in self:
            return self.pop(index, None)
        v = self[index]
        for i in range(index, n):
            self[i] = self[i + 1]
        del self[n]
        return v

    def length(self) -> int:
        i = 1
        while i in self:
            i += 1
        return i - 1

    def array(self):
        return [self[i] for i in range(1, self.length() + 1)]

    def __iter__(self) -> Iterator:
        return iter(self.array()) if self.length() == len(self) \
            else iter(dict.keys(self))

    def get_or_else(self, key, default):
        return self.get(key, default)

    def update_(self, other: dict) -> "Table":
        dict.update(self, other)
        return self

    def clone(self) -> "Table":
        out = Table()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, Table) else v
        return out

    def __repr__(self) -> str:
        items = ", ".join(f"{k}: {v!r}" for k, v in self.items())
        return f"T{{{items}}}"


def T(*args, **kwargs) -> Table:
    """``T(a, b, c)`` builds the array part; ``T(k=v)`` the map part."""
    t = Table()
    for i, a in enumerate(args):
        t[i + 1] = a
    for k, v in kwargs.items():
        t[k] = v
    return t
