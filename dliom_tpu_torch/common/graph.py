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
the graph's memory pool, and graphs replayed one after another can share
one pool.

On a CUDA state the first call is the warm-up: the body runs eagerly on the
static buffers (it loads the kernel library, the K1 update tables, the
cuBLAS/cuSOLVER/cuFFT handles and plans and the constants of
`common/device.py`), then the body is captured and every later call
replays it. A capture that fails raises: a CUDA state never steps eagerly
after the warm-up. On a CPU state every call runs the body eagerly through
the same buffers and copies.

Captures may happen on any thread: the frontend's ingest thread captures
the LIO step, the pose graph's pool workers capture their searches and
solves while the frontend replays. So a capture
  * runs on the calling thread's own stream (its current stream, or a side
    stream of its own where that is the default stream, on which nothing
    can be captured), never on a stream shared by the process;
  * holds one process-wide capture lock from its begin to its end
    (PyTorch takes one capture underway at a time in a process); the eager
    warm-up runs outside the lock;
  * runs under `capture_error_mode="thread_local"`, since other threads run
    on the card meanwhile, and under `preferred_linalg_library("cusolver")`,
    since MAGMA's batched solves synchronize their stream;
  * runs with Python's cyclic garbage collector paused: a collection on the
    capturing thread may destroy a dead graph, which CUDA refuses while the
    thread's stream captures, and the capture is lost ("operation failed
    due to a previous error during capture");
  * synchronizes its own stream after it, not the device;
  * goes into a memory pool chosen by the graph's `pool`: "device", one pool
    per device shared by the graphs that replay one after another on the
    frontend's stream; a `SharedPool`, shared by the graphs given it, which
    one thread replays one after another (a pool worker's searches), and
    freed with them; "own", a private pool (a graph that more than one
    thread replays, one after another).

A device-wide synchronize on any thread while a capture is underway loses
that capture too (and raises on the synchronizing thread): the port
synchronizes streams and events, never the device, where another thread
may be capturing.

The static result and state hold the last step's values until the next
call: a caller that keeps any of them across a step copies it first.

A graph whose body has stages (`common/stages.stage`: the LIO and
frontend steps') also times and counts them in every replay, with device
marks captured between them (`common/stages.py`); `counts()` then
carries their summary.

The kernel wrappers count launches in Python, which a replay does not run.
So each graph records the launches its capture made (and takes them back
off the counters: a capture runs nothing) and adds them on every replay.
The launches a capture records are its own thread's, and every change of
a counter is made under one lock (`common/launches.py`): another thread's
replays during the capture neither count nor get lost.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from dliom_tpu_torch.common import launches as _launches
from dliom_tpu_torch.common import stages
from dliom_tpu_torch.imu import affine_chain as ac
from dliom_tpu_torch.imu import window_optimizer as wo
from dliom_tpu_torch.ops import grouped_apply as ga

# The kernel wrappers' launch counters, (module, global name).
COUNTERS = ((ga, "LAUNCHES"), (ga, "DENSE_LAUNCHES"), (ac, "LAUNCHES"), (wo, "LAUNCHES"))
_ALIGN = 16  # bytes: every input leaf starts on a 16-byte boundary of the flat buffer
COUNTS = ("steps", "warmups", "captures", "replays")  # a StepGraph's counters
POOLS = ("device", "own")  # the named pools; a graph may also be given a SharedPool
_CAPTURE_LOCK = threading.Lock()  # one capture at a time in the process
_SIDE = threading.local()  # a thread's capture stream, where its current one is the default stream

add_launches = _launches.add


def launch_counts() -> Dict[str, int]:
    return {f"{mod.__name__}.{name}": getattr(mod, name) for mod, name in COUNTERS}


def _capture_stream(device: torch.device):
    """The calling thread's own stream for a capture: its current stream, or
    a side stream of its own where the current one is the default stream
    (which cannot capture). A native pool thread, whose `threading.local`
    is new for every task, takes a new one from PyTorch's stream pool per
    task; the pose graph's tasks run on streams of their own anyway."""
    cur = torch.cuda.current_stream(device)
    if cur != torch.cuda.default_stream(device):
        return cur
    streams = _SIDE.__dict__.setdefault("streams", {})
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


@contextlib.contextmanager
def _collector_paused():
    """Python's cyclic garbage collector off inside, as it was after. The
    setting is the process's: captures, which hold the capture lock, are
    the only ones to change it."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def capture(graph: "torch.cuda.CUDAGraph", pool: tuple, device: torch.device, fn: Callable) -> None:
    """Capture fn() into `graph` on the calling thread's own stream, under
    the process-wide capture lock and with the garbage collector paused,
    into `pool` (a handle, or () for a private pool); then synchronize that
    stream. Raises if fn or the capture fails."""
    stream = _capture_stream(device)
    cur = torch.cuda.current_stream(device)
    with _CAPTURE_LOCK, _collector_paused():
        if stream != cur:
            stream.wait_stream(cur)
        with torch.cuda.device(device), torch.cuda.stream(stream):
            graph.capture_begin(*pool, capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                with contextlib.suppress(Exception):
                    graph.capture_end()
                raise
            graph.capture_end()
    stream.synchronize()


class SharedPool:
    """A graph memory pool shared by the graphs given it, which one thread
    replays one after another on one stream. Made at the first capture into
    it, with a small anchor graph that lives as long as this object: a pool
    that outlives its graphs (a capture's cuBLAS workspace stays allocated
    in it) cannot be shared by a later capture unless a graph still holds
    it. Its memory goes back to the allocator with this object and its
    graphs."""

    def __init__(self):
        self._lock = threading.Lock()
        self._handle = self._anchor = None

    def handle(self, device: torch.device) -> tuple:
        with self._lock:
            if self._handle is None:
                handle, anchor = torch.cuda.graph_pool_handle(), torch.cuda.CUDAGraph()
                capture(anchor, (handle,), device, lambda: torch.zeros(1, device=device))
                self._handle, self._anchor = handle, anchor
            return (self._handle,)


_DEVICE_POOLS: Dict[torch.device, SharedPool] = {}
_DEVICE_POOLS_LOCK = threading.Lock()


def pool_handle(pool, device: torch.device) -> tuple:
    """The pool a graph of `pool` ("device", "own" or a SharedPool) captures
    into: () for "own" (a private pool), else a handle shared by the
    device's graphs, kept for the process, or by the SharedPool's."""
    device = torch.device(device)
    if pool == "own":
        return ()
    if pool == "device":
        with _DEVICE_POOLS_LOCK:
            pool = _DEVICE_POOLS.setdefault(device, SharedPool())
    return pool.handle(device)


def _check_pool(pool) -> None:
    if not isinstance(pool, SharedPool) and pool not in POOLS:
        raise ValueError(f"pool: {pool!r} is not one of {POOLS} or a SharedPool")


_LINALG_LOCK = threading.Lock()
_LINALG = {"users": 0, "prev": None}


@contextlib.contextmanager
def cusolver():
    """The CUDA linear algebra of the warm-up and the capture: cuSOLVER and
    cuBLAS, never MAGMA (whose batched solves synchronize their stream). An
    eager step run under it takes the same routines as the graph. The
    choice is the process's, so it is counted: it holds while any thread is
    inside, and the previous choice comes back when the last one leaves.
    Nothing where there is no card."""
    if not torch.cuda.is_available():
        yield
        return
    with _LINALG_LOCK:
        if _LINALG["users"] == 0:
            _LINALG["prev"] = torch.backends.cuda.preferred_linalg_library()
            torch.backends.cuda.preferred_linalg_library("cusolver")
        _LINALG["users"] += 1
    try:
        yield
    finally:
        with _LINALG_LOCK:
            _LINALG["users"] -= 1
            if _LINALG["users"] == 0:
                torch.backends.cuda.preferred_linalg_library(_LINALG["prev"])


def _ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _check_like(what: str, static: torch.Tensor, new: torch.Tensor) -> None:
    if new.shape != static.shape or new.dtype != static.dtype:
        raise ValueError(f"{what}: {tuple(new.shape)} {new.dtype} where the graph holds "
                         f"{tuple(static.shape)} {static.dtype}")


class StepGraph:
    """`body(state, inp) -> (state, result)` as a compiled step; see the
    module docstring. `pool` is one of POOLS or a SharedPool; `name` names
    the program in reports. Counts its steps and, on the card, its
    warm-ups, captures and replays. Where the eager warm-up met stages
    (`common/stages.py`), the capture marks them between a mark before
    the body and one after the write-back; each replay's host entry time
    is kept."""

    def __init__(self, body: Callable, adopt: Callable[[object], Iterable[torch.Tensor]] = lambda s: (),
                 pool: str = "device", name: str = "step"):
        _check_pool(pool)
        self.body = body
        self._adopt = adopt
        self.pool = pool
        self.name = name
        self.state = self.inp = self.result = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.steps = self.warmups = self.captures = self.replays = 0
        self.capture_seconds: Optional[float] = None
        self.launches: Dict[str, int] = {}
        self._lookback = ga.LookbackScratch()
        self._pinned = self._copied = None
        self.marks = stages.StageMarks()

    # ----- binding and copies -----

    def bind(self, state, inp) -> None:
        """Make the static buffers from a state and an input of the step's
        shapes (their values are loaded by `load_state` and `load_input` or
        `stage_input`)."""
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
        in_leaves, self._in_spec = tree_flatten(inp)
        self.device = next(x.device for x in out + in_leaves if x is not None)
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
        entry_ns = time.perf_counter_ns()
        if self.state is None:
            self.bind(state, inp)
        else:
            self.load_state(state)
        self.load_input(inp)
        self._step(entry_ns)
        return self.state, self.result

    def _run(self, marks: Optional[stages.StageMarks] = None) -> None:
        with ga.lookback_owner(self._lookback), stages.owner(marks):
            self._write_back(*self.body(self.state, self.inp))

    def _run_marked(self) -> None:
        self.marks.begin()
        self._run(self.marks)
        self.marks.end()

    def step(self) -> None:
        """One step on the static input already loaded (`load_input` or
        `stage_input`)."""
        self._step(time.perf_counter_ns())

    def _step(self, entry_ns: int) -> None:
        self.steps += 1
        if self.device.type != "cuda":
            self._run()
            return
        # the warm-up's launches and the replay go to the graph's own card,
        # whichever card is current (a mesh's shards step from one thread)
        if self.graph is not None:
            self.marks.host_ns[self.replays % stages.RING] = entry_ns
            with torch.cuda.device(self.device):
                self.graph.replay()
            self.replays += 1
            add_launches(self.launches)
            return
        with cusolver(), torch.cuda.device(self.device):
            self._run(self.marks)
            self.warmups += 1
            self._capture()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        fn = self._run
        if self.marks.rehearsed:
            self.marks.arm(self.device)
            fn = self._run_marked
        with _launches.recording() as own:
            capture(graph, pool_handle(self.pool, self.device), self.device, fn)
        self.launches = {k: own.get(k, 0) for k in launch_counts()}
        add_launches({k: -v for k, v in self.launches.items()})
        self.graph = graph
        self.captures += 1
        self.capture_seconds = time.perf_counter() - t0

    def counts(self) -> dict:
        """Steps, warm-ups, captures and replays; once a capture has marked
        stages also `marks`, the summary of its stage marks
        (`common/stages.py`), read once the calling thread's stream has
        finished."""
        out = {k: getattr(self, k) for k in COUNTS}
        if self.marks.armed:
            out["marks"] = self.marks.summary(self.replays)
        return out


def sum_counts(graphs: Iterable[Optional[StepGraph]]) -> Dict[str, int]:
    """`StepGraph.counts()`'s COUNTS summed over graphs (None: a step not
    made yet); no summary of marks is read."""
    out = dict.fromkeys(COUNTS, 0)
    for g in graphs:
        if g is not None:
            for k in COUNTS:
                out[k] += getattr(g, k)
    return out
