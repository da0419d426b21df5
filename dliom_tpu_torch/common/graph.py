"""Compiled steps: a step body captured once into a CUDA graph and replayed
for every later call, the port's counterpart of the JAX package's jitted
steps (`jax.jit` with the banks donated).

`StepGraph(body, adopt)` owns the step's static buffers: the input (one
flat device buffer, so a host batch goes over in one copy), the state and
the result. A call copies its input in, runs the body on the static state
and input, and copies the body's new state back into the same state
tensors and its result into the static result. The banks (`adopt(state)`)
are updated in place by the body and stay the caller's tensors; every
other leaf of the state is copied once when the graph binds. State in and
state out are the same tensors, so the body's intermediates live only in
the graph's memory pool, and graphs of one device can share one pool
(their replays run one after another on one stream).

On a CUDA state the first call is the warm-up: the body runs eagerly on the
static buffers (it loads the kernel library, the K1 update tables, the
cuBLAS/cuSOLVER handles and the constants of `common/device.py`), then the
body is captured and every later call replays it. Capture runs under
`capture_error_mode="thread_local"`, since other threads may run on the card
meanwhile, and under `preferred_linalg_library("cusolver")`, since MAGMA's
batched solves synchronize their stream. A capture that fails raises: a
CUDA state never steps eagerly after the warm-up. On a CPU state every call
runs the body eagerly through the same buffers and copies.

The static result and state hold the last step's values until the next
call: a caller that keeps any of them across a step copies it first.

The kernel wrappers count launches in Python, which a replay does not run.
So each graph records the launches its capture made (and takes them back
off the counters: a capture runs nothing) and adds them on every replay.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from dliom_tpu_torch.imu import affine_chain as ac
from dliom_tpu_torch.ops import grouped_apply as ga

# The kernel wrappers' launch counters, (module, global name).
COUNTERS = ((ga, "LAUNCHES"), (ga, "DENSE_LAUNCHES"), (ac, "LAUNCHES"))
_ALIGN = 16  # bytes: every input leaf starts on a 16-byte boundary of the flat buffer
_POOLS: Dict[torch.device, tuple] = {}


def launch_counts() -> Dict[str, int]:
    return {f"{mod.__name__}.{name}": getattr(mod, name) for mod, name in COUNTERS}


def add_launches(delta: Dict[str, int]) -> None:
    for mod, name in COUNTERS:
        setattr(mod, name, getattr(mod, name) + delta.get(f"{mod.__name__}.{name}", 0))


def shared_pool(device: torch.device):
    """One graph memory pool per device, shared by the graphs replayed on it
    one after another on one stream. A small anchor graph captured into it
    lives as long as the process: a pool that outlives its graphs (a
    capture's cuBLAS workspace stays allocated in it) cannot be shared by a
    later capture unless a graph still holds it."""
    device = torch.device(device)
    if device not in _POOLS:
        with torch.cuda.device(device):
            handle = torch.cuda.graph_pool_handle()
            anchor = torch.cuda.CUDAGraph()
            with torch.cuda.graph(anchor, pool=handle, capture_error_mode="thread_local"):
                torch.zeros(1, device=device)
            _POOLS[device] = (handle, anchor)
    return _POOLS[device][0]


@contextlib.contextmanager
def cusolver():
    """The CUDA linear algebra of the warm-up and the capture: cuSOLVER and
    cuBLAS, never MAGMA (whose batched solves synchronize their stream). An
    eager step run under it takes the same routines as the graph. Nothing
    where there is no card."""
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _check_like(what: str, static: torch.Tensor, new: torch.Tensor) -> None:
    if new.shape != static.shape or new.dtype != static.dtype:
        raise ValueError(f"{what}: {tuple(new.shape)} {new.dtype} where the graph holds "
                         f"{tuple(static.shape)} {static.dtype}")


class StepGraph:
    """`body(state, inp) -> (state, result)` as a compiled step; see the
    module docstring. Counts its steps and, on the card, its warm-ups,
    captures and replays."""

    def __init__(self, body: Callable, adopt: Callable[[object], Iterable[torch.Tensor]] = lambda s: ()):
        self.body = body
        self._adopt = adopt
        self.state = self.inp = self.result = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.steps = self.warmups = self.captures = self.replays = 0
        self.capture_seconds: Optional[float] = None
        self.launches: Dict[str, int] = {}
        self._lookback = ga.LookbackScratch()
        self._pinned = self._copied = None

    # ----- binding and copies -----

    def _bind(self, state, inp) -> None:
        adopted = {id(x) for x in self._adopt(state)}
        leaves, self._state_spec = tree_flatten(state)
        seen, out = set(), []
        for x in leaves:
            if x is not None and not (id(x) in adopted and x.is_contiguous() and _ptr(x) not in seen):
                x = x.clone(memory_format=torch.contiguous_format)
            if x is not None and x.numel():
                seen.add(_ptr(x))
            out.append(x)
        self._state_leaves = out
        self.state = tree_unflatten(out, self._state_spec)
        self.device = next(x.device for x in out if x is not None)
        in_leaves, self._in_spec = tree_flatten(inp)
        layout, total = [], 0
        for x in in_leaves:
            n = x.numel() * x.element_size()
            layout.append((total, n, tuple(x.shape), x.dtype))
            total += -(-n // _ALIGN) * _ALIGN
        self._in_buf = torch.empty(max(total, _ALIGN), dtype=torch.uint8, device=self.device)
        self._in_leaves = [self._in_buf[o:o + n].view(d).view(shape) for o, n, shape, d in layout]
        self.inp = tree_unflatten(self._in_leaves, self._in_spec)
        self._in_layout = [(o, n, shape, torch.empty(0, dtype=d).numpy().dtype)
                           for o, n, shape, d in layout]
        self._static = {_ptr(x) for x in out + self._in_leaves if x is not None and x.numel()}

    def load_state(self, state) -> None:
        """Make `state` the graph's state: nothing when it is the graph's
        own, else a copy of each leaf that differs into the static tensors."""
        if state is self.state:
            return
        leaves, spec = tree_flatten(state)
        if spec != self._state_spec:
            raise ValueError("the state's structure differs from the graph's")
        for s, x in zip(self._state_leaves, leaves):
            if s is not None and x is not s:
                _check_like("state", s, x)
                s.copy_(x)

    def load_input(self, inp) -> None:
        leaves, spec = tree_flatten(inp)
        if spec != self._in_spec:
            raise ValueError("the input's structure differs from the graph's")
        for s, x in zip(self._in_leaves, leaves):
            _check_like("input", s, x)
            s.copy_(x, non_blocking=True)

    def stage_input(self, arrays) -> None:
        """Copy host arrays (the input's leaves, in order) into the static
        input: written into one pinned host buffer, which goes over in one
        non-blocking copy. An event keeps the buffer from being rewritten
        before its copy has run."""
        if self._pinned is None:
            cuda = self.device.type == "cuda"
            self._pinned = torch.empty(self._in_buf.shape, dtype=torch.uint8, pin_memory=cuda)
            self._copied = torch.cuda.Event() if cuda else None
        elif self._copied is not None:
            self._copied.synchronize()
        host = self._pinned.numpy()
        for (o, n, shape, dtype), a in zip(self._in_layout, arrays):
            a = np.asarray(a, dtype)
            if a.shape != shape:
                raise ValueError(f"input: {a.shape} where the graph holds {shape}")
            host[o:o + n].view(dtype)[:] = a.reshape(-1)
        self._in_buf.copy_(self._pinned, non_blocking=True)
        if self._copied is not None:
            self._copied.record(torch.cuda.current_stream(self.device))

    def _write_back(self, new_state, result) -> None:
        leaves, spec = tree_flatten(new_state)
        if spec != self._state_spec:
            raise ValueError("the body changed the state's structure")
        res_leaves, res_spec = tree_flatten(result)
        if self.result is None:
            self._res_leaves = [None if r is None else torch.empty_like(r, memory_format=torch.contiguous_format)
                                for r in res_leaves]
            self._res_spec = res_spec
            self.result = tree_unflatten(self._res_leaves, res_spec)
        # a new leaf that is (a view of) another static tensor is read
        # before any static tensor is written
        pending = []
        for s, x in zip(self._state_leaves, leaves):
            if s is None or x is s:
                continue
            _check_like("body state", s, x)
            pending.append((s, x.clone() if x.numel() and _ptr(x) in self._static else x))
        for s, x in zip(self._res_leaves, res_leaves):
            if s is not None:
                s.copy_(x)
        for s, x in pending:
            s.copy_(x)

    # ----- stepping -----

    def __call__(self, state, inp):
        if self.state is None:
            self._bind(state, inp)
        else:
            self.load_state(state)
        self.load_input(inp)
        self.step()
        return self.state, self.result

    def _run(self) -> None:
        with ga.lookback_owner(self._lookback):
            self._write_back(*self.body(self.state, self.inp))

    def step(self) -> None:
        """One step on the static input already loaded (`load_input` or
        `stage_input`)."""
        self.steps += 1
        if self.device.type != "cuda":
            self._run()
            return
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            add_launches(self.launches)
            return
        with cusolver():
            self._run()
            self.warmups += 1
            self._capture()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=shared_pool(self.device), capture_error_mode="thread_local"):
            self._run()
        torch.cuda.synchronize(self.device)
        self.launches = {k: v - before[k] for k, v in launch_counts().items()}
        add_launches({k: -v for k, v in self.launches.items()})
        self.graph = graph
        self.captures += 1
        self.capture_seconds = time.perf_counter() - t0

    def counts(self) -> Dict[str, int]:
        return {"steps": self.steps, "warmups": self.warmups, "captures": self.captures,
                "replays": self.replays}


def sum_counts(graphs: Iterable[Optional[StepGraph]]) -> Dict[str, int]:
    """`StepGraph.counts()` summed over graphs (None: a step not made yet)."""
    out = dict.fromkeys(("steps", "warmups", "captures", "replays"), 0)
    for g in graphs:
        for k, v in (g.counts() if g is not None else {}).items():
            out[k] += v
    return out
