"""The kernel library's launch path (`ops/_kernels.py`) on the CPU, with a
stand-in library in place of the built one (no ``nvcc`` needed): each C
function is looked up and typed once, when the library loads; a launch
after that takes no lock; a non-zero return raises with the CUDA error
string; concurrent first launches build and load once."""

import collections
import threading

import pytest

from tbraymarcherplugin_tpu_torch.ops import _kernels

ILLEGAL = b"an illegal memory access was encountered"


class _Fn:
    def __init__(self, lib, name):
        self.lib, self.name = lib, name
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.lib.calls.append((self.name, args))
        if self.name == "tbr_error_string":
            return ILLEGAL
        return self.lib.codes.get(self.name, 0)


class _Lib:
    """Stands in for the ctypes library: counts each lookup by name."""

    def __init__(self):
        self.lookups = collections.Counter()
        self.calls, self.codes = [], {}

    def __getattr__(self, name):
        if not name.startswith("tbr_"):
            raise AttributeError(name)
        self.lookups[name] += 1
        return _Fn(self, name)


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    builds = []

    def build():
        builds.append(1)
        return "libtbr_stand_in.so", 0.0

    monkeypatch.setattr(_kernels, "_lib", None)
    monkeypatch.setattr(_kernels, "_fns", {})
    monkeypatch.setattr(_kernels, "build", build)
    monkeypatch.setattr(_kernels.ctypes, "CDLL", lambda path: fake)
    fake.builds = builds
    return fake


def test_each_function_is_resolved_and_typed_once(lib):
    for _ in range(3):
        _kernels.launch("tbr_row_lerp", 1, 2, 3, 4, 5, 6, 7, 8)
        _kernels.launch("tbr_gather_probe", 1, 2, 3, 4, 5, 6)
    assert set(lib.lookups) == set(_kernels.SIGNATURES) | {"tbr_error_string"}
    assert all(n == 1 for n in lib.lookups.values())
    for name, argtypes in _kernels.SIGNATURES.items():
        assert _kernels._fns[name].argtypes == argtypes
    assert [c[0] for c in lib.calls] == ["tbr_row_lerp",
                                         "tbr_gather_probe"] * 3
    assert lib.calls[0][1] == (1, 2, 3, 4, 5, 6, 7, 8)


def test_launch_takes_no_lock_once_loaded(lib, monkeypatch):
    _kernels.load()

    class NoLock:
        def __enter__(self):
            raise AssertionError("a launch took the lock")

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(_kernels, "_lock", NoLock())
    _kernels.launch("tbr_tf_alpha", 1, 2, 3, 4, 5, 0.5, 6)
    assert _kernels.load() is lib
    assert lib.calls[-1][0] == "tbr_tf_alpha"


def test_nonzero_code_raises_with_the_cuda_error_string(lib):
    lib.codes["tbr_tf_alpha"] = 700
    with pytest.raises(RuntimeError, match="tbr_tf_alpha: CUDA error 700: "
                       + ILLEGAL.decode()):
        _kernels.launch("tbr_tf_alpha", 1, 2, 3, 4, 5, 0.5, 6)
    assert ("tbr_error_string", (700,)) in lib.calls


def test_concurrent_first_launches_load_once(lib):
    errors = []

    def worker():
        try:
            for _ in range(20):
                _kernels.launch("tbr_sum_rows", 1, 2, 3, 4, 5)
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert len(lib.builds) == 1 and lib.lookups["tbr_sum_rows"] == 1
    assert sum(c[0] == "tbr_sum_rows" for c in lib.calls) == 160
