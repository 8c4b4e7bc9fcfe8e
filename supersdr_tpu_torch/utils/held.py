"""A stream's fixed plan: what its chunks would otherwise work out anew.

A chunk's work splits in two. What depends only on the frozen
configuration, the device and the parameters (the tier, the factoring,
the row order and its inverse, tiles, filter designs, tap tables, the
tail's parameter vector) is built on a stream's first chunk and held
for every later chunk; what a chunk does to its own data and state is the
rest. Pure functions of ints or of a frozen configuration are cached where
they are defined (`functools.lru_cache`, `cached_property`); this module
holds the two kinds that need more:

  * `plan`: a chunk's plan, a pure function of hashable arguments
    (configurations, devices), each result held under its arguments and
    each call counted;
  * `FromTensors`: a value derived from tensors (the parameters), held
    under the source tensors themselves. An entry keeps a reference to
    each source, so no other tensor can take a source's identity while the
    entry lives, and is rebuilt once a source's version counter
    (`Tensor._version`, which every in-place write moves: `copy_`, `mul_`,
    an indexed store) has moved since it was built. A new parameters
    object is a new key. Never a key on `data_ptr()`: a freed tensor's
    address is reused.

Each holds at most `maxsize` entries, the oldest dropped first. `plan`
records every call with `profiling.count_plan` (held or built) and
`FromTensors` every build, under the chunk that made it, only while a
profiler runs. `clear()` empties both kinds: the next chunk builds its
plan and its tensors anew. `leaves` and `versions` read a tree's tensors
and their version counters (`runtime/stream_graph` checks its parameters
so).
"""

from __future__ import annotations

import functools

import torch

from supersdr_tpu_torch.utils import profiling

_CLEARS: list = []


def clear() -> None:
    """Forget every value each cache of this module holds."""
    for c in _CLEARS:
        c()


def _put(cache: dict, key, value, maxsize: int) -> None:
    if len(cache) >= maxsize:
        cache.pop(next(iter(cache)), None)
    cache[key] = value


def plan(fn, maxsize: int = 64):
    """A chunk's plan: `fn(*args)` held under its (hashable) arguments;
    each call records whether it found the plan held or built it."""
    cache: dict = {}
    _CLEARS.append(cache.clear)

    @functools.wraps(fn)
    def get(*args):
        try:
            value = cache.get(args)
        except TypeError:          # an unhashable argument: not held
            profiling.count_plan(True)
            return fn(*args)
        if value is None:
            value = fn(*args)
            _put(cache, args, value, maxsize)
            profiling.count_plan(True)
        else:
            profiling.count_plan(False)
        return value
    return get


def leaves(tree) -> list:
    """The tensors of a tree of named tuples and tuples, in field order
    (None fields skipped)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for v in tree if v is not None for x in leaves(v)]


def versions(sources) -> tuple | None:
    """Each source tensor's version counter, or None where one has none."""
    try:
        return tuple(t._version for t in sources)
    except (RuntimeError, AttributeError):
        return None            # an inference tensor (no version), or no tensor


class FromTensors:
    """`build(*sources, *static)` held under its source tensors (compared
    by identity and version) and its hashable `static` arguments."""

    def __init__(self, build, maxsize: int = 16):
        self.build = build
        self.maxsize = maxsize
        self.cache: dict = {}
        _CLEARS.append(self.cache.clear)

    def __call__(self, sources: tuple[torch.Tensor, ...], *static):
        seen = versions(sources)
        if seen is None:
            return self.build(*sources, *static)
        key = (tuple(map(id, sources)), static)
        entry = self.cache.get(key)
        if entry is not None and entry[1] == seen:
            return entry[2]
        value = self.build(*sources, *static)
        # the entry holds its sources: their ids stay theirs while it lives
        _put(self.cache, key, (sources, seen, value), self.maxsize)
        profiling.count_plan(True)
        return value
