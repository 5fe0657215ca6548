"""Carry compiled state across packages as plain data.

A compiled automaton (dense or compressed) and a cascade plan are
dataclasses of numpy arrays, ints, tuples and strings.
:func:`automaton_from_arrays`, :func:`compressed_automaton_from_arrays`
and :func:`plan_from_arrays` rebuild the port's own objects from a plain
dict of those fields (for instance ``{f.name: getattr(obj, f.name) for f in
dataclasses.fields(obj)}`` of another build of the same dataclass), so the
port can scan with tables it did not build itself: the tests run the JAX
package and the port on the very same tables this way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from .core.tables import CompiledAutomaton, CompressedAutomaton
from .models.cascade import CascadePlan


def _build(cls, d: Mapping[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    kw = {}
    for name, v in d.items():
        if isinstance(v, np.ndarray):
            v = np.array(v)  # own copy
        elif isinstance(v, (list, tuple)):
            v = tuple(v)
        kw[name] = v
    return cls(**kw)


def automaton_from_arrays(d: Mapping[str, Any]) -> CompiledAutomaton:
    """The port's :class:`CompiledAutomaton` from a dict of its fields."""
    auto = _build(CompiledAutomaton, d)
    auto.final_start = int(auto.final_start)
    auto.max_len = int(auto.max_len)
    return auto


def compressed_automaton_from_arrays(
    d: Mapping[str, Any],
) -> CompressedAutomaton:
    """The port's :class:`CompressedAutomaton` from a dict of its
    fields."""
    auto = _build(CompressedAutomaton, d)
    for name in ("dense_final_start", "final_start", "max_len"):
        setattr(auto, name, int(getattr(auto, name)))
    return auto


def plan_from_arrays(d: Mapping[str, Any]) -> CascadePlan:
    """The port's :class:`CascadePlan` from a dict of its fields."""
    return _build(CascadePlan, d)
