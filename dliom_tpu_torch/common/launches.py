"""The kernel wrappers' launch counters.

The wrappers count their launches in module globals (`ops/grouped_apply.py`
`LAUNCHES`, `DENSE_LAUNCHES`, `imu/affine_chain.py` `LAUNCHES`,
`imu/window_optimizer.py` `LAUNCHES`), which every
thread adds to: a wrapper's launch, and a CUDA graph's replay, which adds the
launches its capture made (`common/graph.py`). Every change goes through
`count` or `add`, under one lock, so that no thread's addition is lost.

A capture must know the launches of its own thread alone: while one thread
captures, another may replay a graph and add that graph's launches. So a
thread inside `recording()` also gets its own count of the launches it makes.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Dict, Iterator

_TLS = threading.local()
_LOCK = threading.Lock()


def count(module: str, *counters: str) -> None:
    """One launch on each named counter of `module` (its global), and on the
    calling thread's open recording, if it has one."""
    mod = sys.modules[module]
    with _LOCK:
        for c in counters:
            setattr(mod, c, getattr(mod, c) + 1)
    rec = getattr(_TLS, "record", None)
    if rec is not None:
        for c in counters:
            key = f"{module}.{c}"
            rec[key] = rec.get(key, 0) + 1


def add(delta: Dict[str, int]) -> None:
    """Add `delta` ("module.COUNTER" -> n) to the counters; nothing at all
    where every n is 0."""
    items = [(k.rpartition("."), n) for k, n in delta.items() if n]
    if not items:
        return
    with _LOCK:
        for (module, _, name), n in items:
            mod = sys.modules[module]
            setattr(mod, name, getattr(mod, name) + n)


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """The launches this thread counts inside the block, by counter name."""
    prev = getattr(_TLS, "record", None)
    rec: Dict[str, int] = {}
    _TLS.record = rec
    try:
        yield rec
    finally:
        _TLS.record = prev
