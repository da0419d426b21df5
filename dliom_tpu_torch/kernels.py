"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/*.cu` file compiles with its own nvcc for sm_90a, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ctypes. The build runs at first use
into `build/torch_kernels/` at the repository root, under a name that
carries the hash of the sources, so an edited source rebuilds. Nothing here
runs at import: the CPU tests import every module on machines without nvcc.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`, or `SHARED_MEMORY_EXCEEDED` where its block would not
fit; `check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # bank, rows, starts, ends, fresh, keys, hit_table, miss_table,
    # num_steps, cells_per_group, stream
    "dliom_grouped_apply": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    # bank, keys, num_keys, hit_table, miss_table, lookback, num_tiles,
    # dropped, num_groups, cell_bits, stream
    "dliom_grouped_apply_dense": [_P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _P],
    "dliom_dense_tile_keys": [],
    "dliom_empty_launch": [_P],
    # f, q, a_out, p_out, batch, m, stream
    "dliom_affine_chain": [_P, _P, _P, _P, _I, _I, _P],
    # ring, rows, slots, slot, close, stream
    "dliom_stage_mark": [_P, _I, _I, _I, _I, _P],
    # stream, out (int64)
    "dliom_capture_kernels": [_P, _P],
    # inputs (void*[26]), outputs (void*[5]), params (float[8]), batch,
    # window, iterations, stream
    "dliom_window_gn": [_P, _P, _P, _I, _I, _I, _P],
}
# What an entry point returns, beside CUDA's errors, where its block would
# take more shared memory than the card gives one.
SHARED_MEMORY_EXCEEDED = -1

_lib = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdliom_torch_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for the current sources exists;
    returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [str(Path(tmp) / f"{src.stem}.o") for src in _sources()]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                    for src, obj in zip(_sources(), objects)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        results = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in zip(compiles, procs)]
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(Path(tmp) / out.name), *objects]
        if all(code == 0 for _, _, code in results):
            proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            results.append((link, proc.stdout, proc.returncode))
        for cmd, text, code in results:
            if code != 0:
                raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{text}")
        os.replace(Path(tmp) / out.name, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.dliom_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dliom_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    if code == SHARED_MEMORY_EXCEEDED:
        raise ValueError(f"{what}: the launch needs more shared memory than a block may have on this card")
    if code != 0:
        msg = library().dliom_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code} ({msg})")
