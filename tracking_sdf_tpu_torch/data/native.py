"""ctypes binding to the native (C++) frame loader (counterpart of
tracking_sdf_tpu.data.native; the same library, ``native/loader.cpp``).

The loader is a threaded PNG-decode and prefetch pipeline that overlaps disk
reads and decoding with device compute. Its shared library is built with
``make -C native`` (g++ and zlib) at first use in a process; make is a no-op
when the library is newer than its source.

No quiet fallback: when the build fails, ``load_library`` (and with it
``PrefetchingLoader`` and the one-shot decoders) raises ``NativeLoaderError``
with the compiler's output, and a library left from an earlier build is not
loaded in its place. ``available()`` reports whether the library loads; only
the indexed loaders of data.tum use it to choose their plain decoder.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_NAME = "libtsdf_native.so"

_lib = None
_error: Optional["NativeLoaderError"] = None  # a failed build, kept for the process
_lib_lock = threading.Lock()


class NativeLoaderError(RuntimeError):
    """The native loader's library could not be built or loaded."""


def build(force: bool = False) -> str:
    """Run make in the native directory (``force``: rebuild even when the
    library looks fresh, for one made on another machine) and return the
    library's path. Raises NativeLoaderError with the compiler's output."""
    from tracking_sdf_tpu_torch.kernels._build import file_lock

    cmd = ["make", "-C", _NATIVE_DIR, "-s"] + (["-B"] if force else [])
    try:
        # the ranks of a process group may reach here together
        with file_lock("native_loader"):
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except subprocess.CalledProcessError as e:
        said = (e.stderr or e.stdout or b"").decode("utf-8", "replace").strip()[-2000:]
        raise NativeLoaderError(
            f"building the native loader failed ({' '.join(cmd)}):\n"
            f"{said or '(no output)'}") from None
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeLoaderError(
            f"building the native loader failed ({' '.join(cmd)}): "
            f"{type(e).__name__}: {e}") from None
    so = os.path.join(_NATIVE_DIR, _SO_NAME)
    if not os.path.exists(so):
        raise NativeLoaderError(f"make succeeded but {so} is missing")
    return so


def load_library(force_build: bool = False):
    """The loaded library, built first if need be. Raises NativeLoaderError;
    a failure is remembered, so later calls raise it again without building."""
    global _lib, _error
    with _lib_lock:
        if _lib is not None and not force_build:
            return _lib
        if _error is not None and not force_build:
            raise _error
        try:
            lib = ctypes.CDLL(build(force_build))
        except NativeLoaderError as e:
            _error = e
            raise
        except OSError as e:
            _error = NativeLoaderError(f"loading the native loader failed: {e}")
            raise _error from None
        c_int_p = ctypes.POINTER(ctypes.c_int)
        c_float_p = ctypes.POINTER(ctypes.c_float)
        paths = ctypes.POINTER(ctypes.c_char_p)
        lib.tsdf_decode_depth.restype = ctypes.c_int
        lib.tsdf_decode_depth.argtypes = [ctypes.c_char_p, c_float_p, c_int_p, c_int_p,
                                          ctypes.c_int]
        lib.tsdf_decode_rgb.restype = ctypes.c_int
        lib.tsdf_decode_rgb.argtypes = lib.tsdf_decode_depth.argtypes
        lib.tsdf_loader_open.restype = ctypes.c_void_p
        lib.tsdf_loader_open.argtypes = [paths, paths, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int]
        lib.tsdf_loader_open_raw.restype = ctypes.c_void_p
        lib.tsdf_loader_open_raw.argtypes = lib.tsdf_loader_open.argtypes
        lib.tsdf_loader_dims.argtypes = [ctypes.c_void_p, c_int_p, c_int_p]
        lib.tsdf_loader_next.restype = ctypes.c_int
        lib.tsdf_loader_next.argtypes = [ctypes.c_void_p, c_float_p, c_float_p]
        lib.tsdf_loader_next_raw.restype = ctypes.c_int
        lib.tsdf_loader_next_raw.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_uint8), c_int_p]
        lib.tsdf_loader_close.argtypes = [ctypes.c_void_p]
        _lib, _error = lib, None
        return _lib


def available() -> bool:
    """Whether the library loads (building it if need be); never raises."""
    try:
        load_library()
    except NativeLoaderError:
        return False
    return True


def _decode(fn, path: str, channels: int, what: str) -> np.ndarray:
    cap = 4096 * 4096 * channels
    out = np.empty(cap, np.float32)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = fn(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(w), ctypes.byref(h), cap)
    if rc != 0:
        raise ValueError(f"native {what} decode failed ({rc}): {path}")
    shape = (h.value, w.value) + ((channels,) if channels > 1 else ())
    return out[: w.value * h.value * channels].reshape(shape).copy()


def decode_depth(path: str) -> np.ndarray:
    """One-shot native 16-bit depth PNG decode -> float32 meters, NaN holes."""
    return _decode(load_library().tsdf_decode_depth, path, 1, "depth")


def decode_rgb(path: str) -> np.ndarray:
    """One-shot native 8-bit PNG decode -> float32 RGB in [0, 1]."""
    return _decode(load_library().tsdf_decode_rgb, path, 3, "rgb")


class PrefetchingLoader:
    """Ordered iterator over (index, depth, rgb or None) with native
    prefetch. ``raw=True`` yields the TUM wire formats, depth uint16 (0 =
    hole) and rgb uint8, instead of decoded float32. A frame that cannot be
    decoded is skipped (its index is missing from the stream)."""

    def __init__(self, depth_paths: List[str],
                 rgb_paths: Optional[List[Optional[str]]] = None,
                 prefetch: int = 8, threads: int = 0, raw: bool = False):
        self._lib = load_library()
        n = len(depth_paths)
        dp = (ctypes.c_char_p * n)(*[p.encode() for p in depth_paths])
        rp_list = rgb_paths if rgb_paths is not None else [None] * n
        rp = (ctypes.c_char_p * n)(*[(p.encode() if p else None) for p in rp_list])
        self._has_rgb = any(p is not None for p in rp_list)
        self._raw = raw
        opener = self._lib.tsdf_loader_open_raw if raw else self._lib.tsdf_loader_open
        self._handle = opener(dp, rp, n, prefetch, threads)
        if not self._handle:
            raise RuntimeError("tsdf_loader_open failed (is the first frame readable?)")
        w, h = ctypes.c_int(), ctypes.c_int()
        self._lib.tsdf_loader_dims(self._handle, ctypes.byref(w), ctypes.byref(h))
        self.width, self.height = w.value, h.value

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray, Optional[np.ndarray]]]:
        hw = (self.height, self.width)
        ddt, cdt = (np.uint16, np.uint8) if self._raw else (np.float32, np.float32)
        dptr = ctypes.POINTER(ctypes.c_uint16 if self._raw else ctypes.c_float)
        cptr = ctypes.POINTER(ctypes.c_uint8 if self._raw else ctypes.c_float)
        while True:
            depth, rgb = np.empty(hw, ddt), np.empty(hw + (3,), cdt)
            args = [self._handle, depth.ctypes.data_as(dptr), rgb.ctypes.data_as(cptr)]
            if self._raw:
                has = ctypes.c_int()
                rc = self._lib.tsdf_loader_next_raw(*args, ctypes.byref(has))
                has_rgb = bool(has.value)
            else:
                rc = self._lib.tsdf_loader_next(*args)
                # a frame without color comes back filled with -1
                has_rgb = self._has_rgb and rgb.ravel()[0] != -1.0
            if rc == -1:
                return
            if rc == -2:
                continue
            yield rc, depth, (rgb if has_rgb else None)

    def close(self) -> None:
        if self._handle:
            self._lib.tsdf_loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
