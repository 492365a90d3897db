"""Deferred scalars over 0-dim tensors.

Port of ``legionsolvers_tpu/core/scalar.py``.  The reference's ``Scalar<T>``
wraps a Legion future so solver drivers never block (reference:
Scalar.hpp:11-72).  A 0-dim tensor on the device plays that role here:
arithmetic on it enqueues device work and nothing waits for the card until
:meth:`Scalar.get_value` calls ``.item()``.

:func:`alpha_from_scalars` is the reference's future-ratio protocol
(LegionUtilities.cpp:72-97): 0 futures -> 1, 1 -> f0, 2 -> f0/f1,
3 -> (f0*f1)/f2, 4 -> (f0*f1)/(f2*f3).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

Number = Union[int, float, "Scalar"]


def _as_tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.as_tensor(value)


class Scalar:
    """A deferred scalar: wraps a 0-dim tensor.  All arithmetic stays on the
    tensor's device."""

    __slots__ = ("value",)

    def __init__(self, value):
        if isinstance(value, Scalar):
            value = value.value
        self.value = _as_tensor(value)

    # -- arithmetic (reference: Scalar.cpp:26-94) --------------------------
    def _lift(self, other: Number) -> torch.Tensor:
        if isinstance(other, Scalar):
            return other.value
        return torch.as_tensor(other, dtype=self.value.dtype)

    def __add__(self, other: Number) -> "Scalar":
        return Scalar(self.value + self._lift(other))

    __radd__ = __add__

    def __sub__(self, other: Number) -> "Scalar":
        return Scalar(self.value - self._lift(other))

    def __rsub__(self, other: Number) -> "Scalar":
        return Scalar(self._lift(other) - self.value)

    def __mul__(self, other: Number) -> "Scalar":
        return Scalar(self.value * self._lift(other))

    __rmul__ = __mul__

    def __truediv__(self, other: Number) -> "Scalar":
        return Scalar(self.value / self._lift(other))

    def __rtruediv__(self, other: Number) -> "Scalar":
        return Scalar(self._lift(other) / self.value)

    def __neg__(self) -> "Scalar":
        return Scalar(-self.value)

    def sqrt(self) -> "Scalar":
        return Scalar(torch.sqrt(self.value))

    def rsqrt(self) -> "Scalar":
        return Scalar(torch.rsqrt(self.value))

    # -- materialization ---------------------------------------------------
    def get_value(self) -> float:
        """Blocking read (the analog of ``Future::get_result``): the only
        place a single scalar leaves the device."""
        return float(self.value.item())

    def print(self, dummy=None):
        """Print the value (reference: Scalar.cpp:96-116); returns
        ``dummy``, as the JAX package does."""
        print(f"{self.get_value():g}")
        return dummy

    def __repr__(self) -> str:
        return f"Scalar({self.value!r})"


class ScalarHistory(list):
    """A list of :class:`Scalar` materialized lazily from one 1-D tensor.

    Solver loops return their residual history as one device tensor.
    Indexing wraps one element without leaving the device; iteration,
    comparison and the mutating list methods fetch the whole history to the
    host in a single copy first, so cached slots never disagree with the
    backing tensor."""

    def __init__(self, arr: torch.Tensor):
        super().__init__([None] * int(arr.shape[0]))
        self._arr = arr

    def _get(self, i: int) -> Scalar:
        v = list.__getitem__(self, i)
        if v is None:
            v = Scalar(self._arr[i])
            list.__setitem__(self, i, v)
        return v

    def _materialize_all(self):
        missing = [i for i in range(len(self))
                   if list.__getitem__(self, i) is None]
        if missing:  # one host copy instead of len(self) device reads
            vals = self._arr.cpu()
            for i in missing:
                list.__setitem__(self, i, Scalar(vals[i]))

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._get(j) for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
            if i < 0:
                raise IndexError("ScalarHistory index out of range")
        return self._get(i)

    def __iter__(self):
        self._materialize_all()
        return super().__iter__()

    def __reversed__(self):
        self._materialize_all()
        return super().__reversed__()

    def __repr__(self):
        self._materialize_all()
        return f"ScalarHistory({list.__repr__(self)})"

    def __eq__(self, other):
        self._materialize_all()
        if isinstance(other, ScalarHistory):
            other._materialize_all()
        return list.__eq__(self, other)

    __hash__ = None

    def __contains__(self, item):
        self._materialize_all()
        return super().__contains__(item)

    def _mat_then(name):
        def method(self, *a, **kw):
            self._materialize_all()
            return getattr(list, name)(self, *a, **kw)

        method.__name__ = name
        return method

    index = _mat_then("index")
    count = _mat_then("count")
    insert = _mat_then("insert")
    remove = _mat_then("remove")
    pop = _mat_then("pop")
    sort = _mat_then("sort")
    reverse = _mat_then("reverse")
    __setitem__ = _mat_then("__setitem__")
    __delitem__ = _mat_then("__delitem__")
    del _mat_then


def alpha_from_scalars(scalars: Sequence[Scalar]) -> torch.Tensor:
    """The reference's future-ratio protocol (LegionUtilities.cpp:72-97).
    Anything but 0-4 scalars is an error, as in the reference."""
    vals = [s.value if isinstance(s, Scalar) else _as_tensor(s) for s in scalars]
    if len(vals) == 0:
        return torch.tensor(1.0)
    if len(vals) == 1:
        return vals[0]
    if len(vals) == 2:
        return vals[0] / vals[1]
    if len(vals) == 3:
        return (vals[0] * vals[1]) / vals[2]
    if len(vals) == 4:
        return (vals[0] * vals[1]) / (vals[2] * vals[3])
    raise ValueError(f"alpha_from_scalars: got {len(vals)} scalars, expected 0-4")
