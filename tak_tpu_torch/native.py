"""ctypes bindings for the native takcore engine (`native/takcore.cpp`).

Counterpart of `tak_tpu/native.py`: the framework's independent rules
oracle and low-latency host engine; the device path never uses it.  The
port loads the committed `native/libtakcore.so`.  That library is built
for the host that committed it, so it is first loaded and called in a
child process; if that fails (no such file, another architecture, an
instruction this CPU lacks), the library is built from
`native/takcore.cpp` with the host's `g++` into the port's build
directory (`build/tak_tpu_torch/native/`, git-ignored), never inside
`native/`.  Without a working library `available()` returns False.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[1]
_NATIVE_DIR = _REPO / "native"
COMMITTED_LIB = _NATIVE_DIR / "libtakcore.so"
BUILT_LIB = _REPO / "build" / "tak_tpu_torch" / "native" / "libtakcore.so"
_lib = None
_tried = False
LIB_PATH: Path | None = None   # the library in use, once loaded

# a child process loads the library and plays one move: a library that
# this host cannot run kills the child, not the caller
_PROBE = (
    "import ctypes, sys; lib = ctypes.CDLL(sys.argv[1]); "
    "lib.tak_new.restype = ctypes.c_void_p; "
    "g = ctypes.c_void_p(lib.tak_new(5, 0)); lib.tak_play(g, 0); "
    "sys.exit(0 if lib.tak_ply(g) == 1 else 1)")


def _runs(path: Path) -> bool:
    if not path.exists():
        return False
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE, str(path)],
                             capture_output=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return False
    return out.returncode == 0


def _build() -> bool:
    """Compile `native/takcore.cpp` into BUILT_LIB (portable flags)."""
    BUILT_LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = BUILT_LIB.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17",
             "-shared", "-o", str(tmp), str(_NATIVE_DIR / "takcore.cpp")],
            check=True, capture_output=True, timeout=300)
        os.replace(tmp, BUILT_LIB)
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def _load():
    global _lib, _tried, LIB_PATH
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = None
    for candidate in (COMMITTED_LIB, BUILT_LIB):
        if _runs(candidate):
            path = candidate
            break
    if path is None:
        if not (_build() and _runs(BUILT_LIB)):
            return None
        path = BUILT_LIB
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.tak_new.restype = ctypes.c_void_p
    lib.tak_new.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.tak_clone.restype = ctypes.c_void_p
    lib.tak_clone.argtypes = [ctypes.c_void_p]
    lib.tak_free.argtypes = [ctypes.c_void_p]
    lib.tak_reset.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.tak_play.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tak_result.argtypes = [ctypes.c_void_p]
    lib.tak_legal.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.tak_perft.restype = ctypes.c_longlong
    lib.tak_perft.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for name in ("tak_ply", "tak_to_move", "tak_result", "tak_reversible"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("tak_stones", "tak_caps", "tak_height", "tak_top"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tak_stack_color.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.tak_set_reserves.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    _lib = lib
    LIB_PATH = path
    return _lib


def available() -> bool:
    return _load() is not None


class NativeGame:
    """Host-side Tak game backed by the C++ engine."""

    def __init__(self, n: int, half_komi: int = 0, _handle=None):
        lib = _load()
        if lib is None:
            raise RuntimeError("takcore native library unavailable")
        self._lib = lib
        self.n = n
        self._g = _handle or lib.tak_new(n, half_komi)

    def __del__(self):
        if getattr(self, "_g", None):
            self._lib.tak_free(self._g)
            self._g = None

    def clone(self) -> "NativeGame":
        return NativeGame(self.n, _handle=self._lib.tak_clone(self._g))

    @property
    def ply(self) -> int:
        return self._lib.tak_ply(self._g)

    @property
    def to_move(self) -> int:
        return self._lib.tak_to_move(self._g)

    @property
    def result(self) -> int:
        return self._lib.tak_result(self._g)

    def play_action(self, action: int) -> None:
        self._lib.tak_play(self._g, int(action))

    def legal_actions(self) -> np.ndarray:
        buf = (ctypes.c_int * 4096)()
        cnt = self._lib.tak_legal(self._g, buf, 4096)
        return np.ctypeslib.as_array(buf)[:cnt].copy()

    def perft(self, depth: int) -> int:
        return self._lib.tak_perft(self._g, depth)

    def reserves(self) -> tuple[int, int, int, int]:
        lib, g = self._lib, self._g
        return (lib.tak_stones(g, 0), lib.tak_caps(g, 0),
                lib.tak_stones(g, 1), lib.tak_caps(g, 1))

    def board_arrays(self):
        """(heights, tops, stack_colors_list) for differential testing."""
        n2 = self.n * self.n
        heights = np.array([self._lib.tak_height(self._g, s) for s in range(n2)])
        tops = np.array([self._lib.tak_top(self._g, s) for s in range(n2)])
        colors = [
            [self._lib.tak_stack_color(self._g, s, h) for h in range(heights[s])]
            for s in range(n2)
        ]
        return heights, tops, colors
