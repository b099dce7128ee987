"""Native runtime bindings (ctypes over the C++ support library).

Builds ``native/runtime.cpp`` on first use with g++ and caches the shared
object next to the source (ignored by git: it is always built from the
committed source).  Every entry
point has a pure-Python fallback so the framework still works without a
toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).parent / "native"
_SO_PATH = _NATIVE_DIR / "libgrt_runtime.so"
_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _build() -> Path | None:
    global _build_error
    src = _NATIVE_DIR / "runtime.cpp"
    if _SO_PATH.exists() and _SO_PATH.stat().st_mtime >= src.stat().st_mtime:
        return _SO_PATH
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        str(src), "-o", str(_SO_PATH), "-lz", "-lpthread",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
        return _SO_PATH
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as e:
        _build_error = getattr(e, "stderr", str(e)) or str(e)
        return None


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))

        lib.grt_build_mips.restype = ctypes.c_int
        lib.grt_build_mips.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.grt_obj_load.restype = ctypes.c_void_p
        lib.grt_obj_load.argtypes = [ctypes.c_char_p]
        lib.grt_obj_vertex_count.restype = ctypes.c_int
        lib.grt_obj_vertex_count.argtypes = [ctypes.c_void_p]
        lib.grt_obj_index_count.restype = ctypes.c_int
        lib.grt_obj_index_count.argtypes = [ctypes.c_void_p]
        lib.grt_obj_copy.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.grt_obj_free.argtypes = [ctypes.c_void_p]

        lib.grt_writer_create.restype = ctypes.c_void_p
        lib.grt_writer_create.argtypes = [ctypes.c_int]
        lib.grt_writer_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ]
        lib.grt_writer_pending.restype = ctypes.c_int
        lib.grt_writer_pending.argtypes = [ctypes.c_void_p]
        lib.grt_writer_failures.restype = ctypes.c_int
        lib.grt_writer_failures.argtypes = [ctypes.c_void_p]
        lib.grt_writer_destroy.argtypes = [ctypes.c_void_p]

        _lib = lib
        return _lib


# ---------------------------------------------------------------------------
# Mip pyramid
# ---------------------------------------------------------------------------

def build_mips(image: np.ndarray, max_levels: int = 10):
    """(h, w, c) float32 -> (atlas (h, 2w, c), level_w, level_h, level_x).

    Native 2x2 box-filter chain; numpy fallback mirrors it exactly.
    """
    image = np.ascontiguousarray(image, dtype=np.float32)
    h, w, c = image.shape
    lib = get_lib()
    if lib is not None:
        atlas = np.zeros((h, 2 * w, c), dtype=np.float32)
        lw = np.zeros(max_levels, dtype=np.int32)
        lh = np.zeros(max_levels, dtype=np.int32)
        lx = np.zeros(max_levels, dtype=np.int32)
        n = lib.grt_build_mips(
            image.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            h, w, c, max_levels,
            atlas.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            lh.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            lx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        return atlas, lw[:n].copy(), lh[:n].copy(), lx[:n].copy()

    # numpy fallback
    atlas = np.zeros((h, 2 * w, c), dtype=np.float32)
    lw, lh, lx = [], [], []
    cur, x = image, 0
    for _ in range(max_levels):
        ch, cw, _ = cur.shape
        atlas[:ch, x:x + cw] = cur
        lw.append(cw)
        lh.append(ch)
        lx.append(x)
        x += cw
        nh, nw = (ch + 1) // 2, (cw + 1) // 2
        if (nh, nw) == (ch, cw):
            break
        pad = np.pad(cur, ((0, ch % 2), (0, cw % 2), (0, 0)), mode="edge")
        cur = pad.reshape(nh, 2, nw, 2, c).mean(axis=(1, 3))
    return (atlas, np.asarray(lw, np.int32), np.asarray(lh, np.int32),
            np.asarray(lx, np.int32))


# ---------------------------------------------------------------------------
# OBJ loading
# ---------------------------------------------------------------------------

def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file -> (positions (V, 3) f32, indices (T, 3) i32)."""
    lib = get_lib()
    if lib is not None:
        handle = lib.grt_obj_load(str(path).encode())
        if not handle:
            raise IOError(f"cannot load obj {path}")
        try:
            nv = lib.grt_obj_vertex_count(handle)
            ni = lib.grt_obj_index_count(handle)
            pos = np.zeros((nv, 3), dtype=np.float32)
            idx = np.zeros((ni,), dtype=np.int32)
            lib.grt_obj_copy(
                handle,
                pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            )
            return pos, idx.reshape(-1, 3)
        finally:
            lib.grt_obj_free(handle)

    # python fallback
    positions, indices = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                positions.append([float(v) for v in parts[1:4]])
            elif line.startswith("f "):
                face = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    face.append(i - 1 if i > 0 else len(positions) + i)
                for k in range(2, len(face)):
                    indices.append([face[0], face[k - 1], face[k]])
    return (np.asarray(positions, dtype=np.float32),
            np.asarray(indices, dtype=np.int32))


# ---------------------------------------------------------------------------
# Async frame writer
# ---------------------------------------------------------------------------

class AsyncFrameWriter:
    """Fire-and-forget PNG writing on native worker threads (the reference's
    nonblocking readback/screenshot pipeline, main.cpp:434-523, 2777-2808).

    Falls back to synchronous writes via imageio/PIL when the native library
    is unavailable.
    """

    def __init__(self, threads: int = 2):
        self._lib = get_lib()
        self._handle = (self._lib.grt_writer_create(threads)
                        if self._lib is not None else None)

    def submit(self, path: str, rgb8: np.ndarray) -> None:
        rgb8 = np.ascontiguousarray(rgb8, dtype=np.uint8)
        h, w, c = rgb8.shape
        assert c == 3, "writer expects (H, W, 3) uint8"
        if self._handle is not None:
            self._lib.grt_writer_submit(
                self._handle, str(path).encode(),
                rgb8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
            )
            return
        from ..utils import png

        png.write(path, rgb8)

    @property
    def pending(self) -> int:
        if self._handle is None:
            return 0
        return self._lib.grt_writer_pending(self._handle)

    @property
    def failures(self) -> int:
        if self._handle is None:
            return 0
        return self._lib.grt_writer_failures(self._handle)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.grt_writer_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
