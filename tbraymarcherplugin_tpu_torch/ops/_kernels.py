"""Build and load the port's hand-written CUDA kernels.

All ``csrc/*.cu`` sources compile at first use with ``nvcc`` for
``sm_90a`` (Hopper), one ``nvcc`` per source, all started together, and
link into one shared library with a plain C interface, loaded with
``ctypes``. Pointers come from ``data_ptr()`` and the stream is the raw
handle of PyTorch's current stream. Each C function is looked up and typed
once, when the library loads; a launch then takes no lock and makes no
lookup. The library lands in
``tbraymarcherplugin_tpu_torch/_build/`` under a name that hashes the
sources and flags, so an edited source never loads a stale build.

Nothing here runs at import: the CPU-only test environment imports every
module and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from ..utils.device import to_device

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
BUILD_TIMEOUT_S = 900

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_COMPOSITE = [_P] * 12 + [_I] * 6 + [_F] * 4 + [_P]
_COMPOSITE_BWD = [_P] * 13 + [_I] * 7 + [_F] * 4 + [_P]
_L = ctypes.c_longlong
_PRESHEAR = [_P, _L, _L, _L, _I, _I, _P, _P] + [_I] * 6 + [_P]
_PRESHEAR_ADJOINT = ([_P] * 3 + [_L] * 3 + [_I] * 3 + [_P, _P] + [_I] * 6
                     + [_P])
SIGNATURES = {
    "tbr_composite_f32": _COMPOSITE,
    "tbr_composite_bf16": _COMPOSITE,
    "tbr_composite_bwd_f32": _COMPOSITE_BWD,
    "tbr_composite_bwd_bf16": _COMPOSITE_BWD,
    "tbr_row_lerp": [_P, _P, _P, _I, _I, _I, _I, _P],
    "tbr_row_lerp_bwd": [_P, _P, _P, _I, _I, _I, _I, _P],
    "tbr_tf_alpha": [_P, _P, _P, _P, ctypes.c_longlong, _F, _P],
    "tbr_occluder_alpha": [_P] * 7 + [_F, _P],
    "tbr_tf_alpha_bwd": [_P] * 9 + [ctypes.c_longlong, _F, _I, _P],
    "tbr_light_scan": [_P, _P, _P, ctypes.c_ulonglong] + [_I] * 14
    + [_F, _I, _F, _P, _F, _P, _P],
    "tbr_device_attribute": [_I],
    "tbr_light_scan_bwd": [_P] * 8 + [ctypes.c_ulonglong] + [_I] * 4
    + [_F, _I, _F, _I, _F, _I, _F] + [_P, _P],
    "tbr_light_scan_bwd_blocks": [_I, _I],
    "tbr_light_scan_bwd_route": [_I, _I],
    "tbr_sum_rows": [_P, _P, _I, _I, _P],
    "tbr_march": [_P] * 7 + [_I] * 11 + [_F] * 6 + [_I, _P],
    "tbr_tf_rgba": [_P] * 5 + [ctypes.c_longlong] * 2 + [_P],
    "tbr_tf_rgba_bwd": [_P] * 11 + [ctypes.c_longlong] * 2 + [_I, _P],
    "tbr_gather_probe": [_P] * 3 + [ctypes.c_longlong, _I, _P],
    "tbr_preshear_f32": _PRESHEAR,
    "tbr_preshear_bf16": _PRESHEAR,
    "tbr_preshear_adjoint_f32": _PRESHEAR_ADJOINT,
    "tbr_preshear_adjoint_bf16": _PRESHEAR_ADJOINT,
}

_lib = None
_fns: dict = {}  # name -> typed ctypes function, filled once by load()
_lock = threading.Lock()


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtbr_kernels_{h.hexdigest()[:16]}.so"


def _compile_all(nvcc: str, sources, out_dir: str) -> list[str]:
    """Compile each source to an object, all ``nvcc`` processes at once;
    kill every one still running if any fails or the build times out."""
    procs = []
    try:
        for src in sources:
            obj = os.path.join(out_dir, src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )))
        deadline = time.monotonic() + BUILD_TIMEOUT_S
        errors = []
        for src, _, proc in procs:
            _, err = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            if proc.returncode != 0:
                errors.append(
                    f"{src.name} ({proc.returncode}):\n{err[-6000:]}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        return [obj for _, obj, _ in procs]
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def build() -> tuple[Path, float]:
    """Compile the kernels if this exact source set is not built yet.
    Returns (library path, seconds spent compiling)."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu = [s for s in _sources() if s.suffix == ".cu"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = _compile_all(nvcc, cu, tmp)
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs],
            capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-8000:]}"
            )
        os.replace(lib, path)  # atomic: a concurrent build never sees half
    return path, time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; its C functions are typed
    and kept in ``_fns`` before it is published."""
    global _lib
    if _lib is not None:  # loaded: no lock
        return _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[name] = fn
            fn = lib.tbr_error_string
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_char_p
            _fns["tbr_error_string"] = fn
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call C entry point ``name``; raise if it reports a CUDA error."""
    fn = _fns.get(name)
    if fn is None:
        load()
        fn = _fns[name]
    err = fn(*args)
    if err != 0:
        msg = _fns["tbr_error_string"](err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def query(name: str, *args) -> int:
    """Call C function ``name`` that returns a number, not an error."""
    fn = _fns.get(name)
    if fn is None:
        load()
        fn = _fns[name]
    return fn(*args)


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device (no Python
    stream object is built)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# Counts of finished blocks of the kernels whose last block finishes the
# call (K8, K10b), one per device and stream: launches on one stream never
# overlap, and the last block sets the count back to 0.
_DONE_COUNTERS: dict = {}


def done_counter(device: torch.device, stream: int) -> torch.Tensor:
    """The finished-block count of ``stream`` on ``device``, zero-filled
    when it is first asked for."""
    key = (device.index, stream)
    if key not in _DONE_COUNTERS:
        _DONE_COUNTERS[key] = torch.zeros(1, dtype=torch.int32,
                                          device=device)
    return _DONE_COUNTERS[key]


def sum_partials(partials: torch.Tensor) -> torch.Tensor:
    """Column sums of a (B, C) array of per-block partials, the rows added
    in order (`csrc/reduce.cu`): the same bits on every run."""
    check(partials, "partials", torch.float32, partials.device)
    B, C = partials.shape
    out = torch.empty(C, dtype=torch.float32, device=partials.device)
    launch("tbr_sum_rows", partials.data_ptr(), out.data_ptr(), B, C,
           stream_of(partials))
    return out


def window_tensor(windowing_vec4, device) -> torch.Tensor:
    """(4,) float32 window (center, width, low cutoff, high cutoff) on
    ``device``; a tensor already there is used as it is (gradients flow)."""
    win = to_device(windowing_vec4, device, torch.float32)
    if win.shape != (4,):
        raise ValueError(f"window must hold 4 values, got {tuple(win.shape)}")
    return win


def check(t: torch.Tensor, name: str, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
