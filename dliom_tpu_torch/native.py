"""Native (C++) host runtime bindings (port of dliom_tpu/native/__init__.py,
which cannot be imported without jax).

The host runtime around the device work — cross-sensor time-ordered
collation and the background task DAG — is the repository's C++
`native/runtime.cpp`, the counterpart of the reference's
`sensor::OrderedMultiQueue` and `common::ThreadPool` + `Task`. It is bound
with ctypes; the shared library builds with g++ at first use into the
repository's `build/native/` tree (rebuilt when the source is newer)."""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

_REPO_ROOT = Path(__file__).resolve().parent.parent
_SRC = _REPO_ROOT / "native" / "runtime.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "native"
_SO = BUILD_DIR / "libdliom_runtime.so"

_lib = None
_lib_lock = threading.Lock()


def _build() -> str:
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", str(_SRC), "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, _SO)
    return str(_SO)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.omq_create.restype = ctypes.c_void_p
            lib.omq_create.argtypes = [ctypes.c_int]
            lib.omq_destroy.argtypes = [ctypes.c_void_p]
            lib.omq_add.restype = ctypes.c_int
            lib.omq_add.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_int64,
            ]
            lib.omq_finish_queue.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.omq_num_dropped.restype = ctypes.c_int64
            lib.omq_num_dropped.argtypes = [ctypes.c_void_p]
            lib.omq_dispatch.restype = ctypes.c_int
            lib.omq_dispatch.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int,
            ]
            lib.pool_create.restype = ctypes.c_void_p
            lib.pool_create.argtypes = [ctypes.c_int]
            lib.pool_destroy.argtypes = [ctypes.c_void_p]
            _TASK_FN = ctypes.CFUNCTYPE(None, ctypes.c_int64)
            lib.pool_add_task.restype = ctypes.c_int64
            lib.pool_add_task.argtypes = [
                ctypes.c_void_p, _TASK_FN, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ]
            lib.pool_wait_all.argtypes = [ctypes.c_void_p]
            lib.pool_num_completed.restype = ctypes.c_int64
            lib.pool_num_completed.argtypes = [ctypes.c_void_p]
            lib._TASK_FN = _TASK_FN
            _lib = lib
    return _lib


class OrderedMultiQueue:
    """Cross-sensor time-ordered merge (sensor::OrderedMultiQueue analog).

    Payloads stay in Python (a handle table); the native side enforces the
    dispatch rule: an item is released only when every other unfinished
    queue holds a later item."""

    def __init__(self, queue_names: Sequence[str]):
        self._lib = _load()
        self._names = list(queue_names)
        self._ids = {n: i for i, n in enumerate(self._names)}
        self._ptr = self._lib.omq_create(len(self._names))
        self._payloads: Dict[int, object] = {}
        self._next_handle = 0
        self._lock = threading.Lock()

    def add(self, queue: str, time: float, payload) -> bool:
        with self._lock:
            h = self._next_handle
            self._next_handle += 1
            self._payloads[h] = payload
        ok = self._lib.omq_add(self._ptr, self._ids[queue], float(time), h)
        if not ok:
            with self._lock:
                del self._payloads[h]
        return bool(ok)

    def finish_queue(self, queue: str) -> None:
        self._lib.omq_finish_queue(self._ptr, self._ids[queue])

    @property
    def num_dropped(self) -> int:
        return int(self._lib.omq_num_dropped(self._ptr))

    def dispatch(self, max_items: int = 256) -> List[Tuple[str, float, object]]:
        handles = (ctypes.c_int64 * max_items)()
        queues = (ctypes.c_int * max_items)()
        times = (ctypes.c_double * max_items)()
        n = self._lib.omq_dispatch(self._ptr, handles, queues, times, max_items)
        out = []
        with self._lock:
            for i in range(n):
                out.append(
                    (
                        self._names[queues[i]],
                        times[i],
                        self._payloads.pop(handles[i]),
                    )
                )
        return out

    def __del__(self):
        try:
            self._lib.omq_destroy(self._ptr)
        except Exception:
            pass


class TaskThreadPool:
    """Background task DAG (common::ThreadPool + Task analog). Python
    callables run on native worker threads (ctypes callbacks reacquire the
    GIL); dependencies gate execution order."""

    def __init__(self, num_threads: int = 4):
        self._lib = _load()
        self._ptr = self._lib.pool_create(num_threads)
        self._callables: Dict[int, Callable[[], None]] = {}
        self._errors: List[BaseException] = []
        self._next = 0
        self._lock = threading.Lock()

        def trampoline(user_data):
            with self._lock:
                fn = self._callables.pop(int(user_data))
            try:
                fn()
            except BaseException as e:  # surfaced on wait_all
                with self._lock:
                    self._errors.append(e)

        # keep a reference so the callback isn't garbage collected
        self._trampoline = self._lib._TASK_FN(trampoline)

    def add_task(
        self, fn: Callable[[], None], depends_on: Sequence[int] = ()
    ) -> int:
        with self._lock:
            uid = self._next
            self._next += 1
            self._callables[uid] = fn
        deps = (ctypes.c_int64 * max(1, len(depends_on)))(*depends_on)
        return int(
            self._lib.pool_add_task(
                self._ptr, self._trampoline, uid, deps, len(depends_on)
            )
        )

    def wait_all(self) -> None:
        self._lib.pool_wait_all(self._ptr)
        with self._lock:
            if self._errors:
                err = self._errors[0]
                self._errors.clear()
                raise err

    @property
    def num_completed(self) -> int:
        return int(self._lib.pool_num_completed(self._ptr))

    def close(self):
        if self._ptr:
            self._lib.pool_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
