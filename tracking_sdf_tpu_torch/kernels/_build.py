"""Compile ``csrc/*.cu`` with nvcc into one shared library and load it with ctypes.

The library exposes plain C entry points that return ``cudaGetLastError()``;
pointers and the CUDA stream are passed as ``c_void_p``. It is built at first
use into ``build/torch_kernels/`` beside the package, under a file name that
carries a hash of the sources and flags, so an edited source rebuilds. Each
source compiles to an object in its own nvcc process, all started together,
and one more nvcc call links the objects. Nothing here runs at import time:
the CPU tests import every module.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("gn_reduce.cu", "brick_merge.cu", "brick_fuse.cu", "preprocess.cu",
           "brick_classify.cu", "stamp.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # dm, bf16, m, bi, bj, bk, pitch, pts, n, w, sh, sw, ox, oy, oz, sx, sy,
    # sz, partials, blocks, state, max_iterations, min_iterations,
    # signed_conv, reference_update, max_twist_diff, damping_decay, stream
    "tsdf_gn_step": [_P] + [_I] * 6 + [_P] + [_I] * 4 + [_F] * 6 + [_P, _I, _P]
                    + [_I] * 4 + [_F, _F, _P],
    # dm, bf16, m, mi, i0, slab, bi, bj, bk, pitch, pts, n, w, sh, sw, ox, oy,
    # oz, sx, sy, sz, partials, blocks, state, max_iterations, out, stream
    "tsdf_gn_reduce_slab": [_P] + [_I] * 9 + [_P] + [_I] * 4 + [_F] * 6
                           + [_P, _I, _P, _I, _P, _P],
    # D, W, d_bf16, w_bf16, m, bi, bj, bk, pitch, pts, n, w, sh, sw, ox, oy,
    # oz, sx, sy, sz, vh, wh, ih0-ih5, partials, blocks, state,
    # max_iterations, min_iterations, signed_conv, reference_update,
    # max_twist_diff, damping_decay, stream
    "tsdf_gn_central_step": [_P, _P] + [_I] * 7 + [_P] + [_I] * 4 + [_F] * 14
                            + [_P, _I, _P] + [_I] * 4 + [_F, _F, _P],
    # sums, state, max_iterations, min_iterations, signed_conv,
    # reference_update, max_twist_diff, damping_decay, stream
    "tsdf_gn_finish": [_P, _P] + [_I] * 4 + [_F, _F, _P],
    # D, W, R, G, B, Wc, upd, channels, bid, cls, slot, n, m, bi, bj, bk,
    # delta, max_weight, stream
    "tsdf_brick_merge": [_P] * 7 + [_I] + [_P] * 3 + [_I] * 5 + [_F, _F, _P],
    # D, W, C, c_width, value_bf16, weight_bf16, upd, channels, ids, n_ids,
    # cap, nb, bv, delta, max_weight, stream
    "tsdf_brick_merge_rows": [_P] * 3 + [_I] * 3 + [_P, _I, _P] + [_I] * 4
                             + [_F, _F, _P],
    # D, W, C, c_width, value_bf16, weight_bf16, ids, n_ids, cap, nb, bi, bj,
    # bk, m, i_offset, pix, channels, img_h, img_w, R, t, sat (or NULL), sj, sk,
    # point_to_plane, weighting, sx, sy, sz, ox, oy, oz, fx, fy, cx, cy, delta,
    # eps, w_delta, w_inv, max_weight, stream
    "tsdf_brick_fuse_rows": [_P] * 3 + [_I] * 3 + [_P] + [_I] * 8 + [_P] + [_I] * 3
                            + [_P, _P, _P] + [_I] * 4 + [_F] * 15 + [_P],
    # in, out, h, w, mode, radius, sw (host), inv2sr, vec, stream
    "tsdf_bilateral_pass": [_P, _P] + [_I] * 4 + [_P, _F, _I, _P],
    # in, out, h, w, radius, sw (host: the compiled radius's, one a squared
    # distance), table (device, (2 radius + 1)^2), inv2sr, vec, stream
    "tsdf_bilateral_2d": [_P, _P] + [_I] * 3 + [_P, _P, _F, _I, _P],
    # depth (or NULL), points, normals, h, w, inv_fx, inv_fy, cx, cy, factor,
    # radius, vec, stream
    "tsdf_normals": [_P] * 3 + [_I] * 2 + [_F] * 5 + [_I] * 2 + [_P],
    # pts, nrm, rgb, pix, mip, ticket, levels, h, w, mode, point_to_plane,
    # channels, vec, cx, cy, inv_fx, inv_fy, delta, share_margin, stream
    "tsdf_frame_tables": [_P] * 7 + [_I] * 6 + [_F] * 6 + [_P],
    # form, zeta, zeta_down, eta, eta_down, levels, R, base, sat, mixed_ids,
    # cls, sat_super, gid, nbi, nbj, nbk, bi, bj, bk, i_offset, f, n_slots,
    # ns, nsj, nsk, nb, img_h, img_w, si, sj, sk, ox, oy, oz, fx, fy, cx, cy,
    # inv_span, lanes, stream
    "tsdf_classify_bricks": [_I] + [_P] * 12 + [_I] * 15 + [_F] * 11 + [_I, _P],
    # cls, skip, n, cap_a, cap_b, fill, ids, counts, scratch, scratch_tiles,
    # vec, stream
    "tsdf_compact_lists": [_P, _P] + [_I] * 4 + [_P] * 3 + [_I, _I, _P],
    # fcls, gid, sat, sf_ids, super_counts, ids, counts, scratch, n, cap,
    # cap_free, cap_sfree, cap_mixed, f, nsj, nsk, nbj, nbk, nb, ns,
    # scratch_tiles, vec, stream
    "tsdf_compact_lists_hier": [_P] * 8 + [_I] * 14 + [_P],
    # out (one int64), stream
    "tsdf_device_stamp": [_P, _P],
}

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libtsdf_kernels_{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def file_lock(name: str):
    """An exclusive lock across processes on ``build/NAME.lock`` (the ranks
    of a process group started together build once, not in a race)."""
    path = BUILD_DIR.parent / f"{name}.lock"
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> Path:
    """Compile the library unless a build of these sources exists (under
    ``file_lock``: another process may be building it)."""
    so = library_path()
    if so.exists():
        return so
    with file_lock("torch_kernels"):
        return so if so.exists() else _compile(so)


def _compile(so: Path) -> Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(name).stem}.o" for name in SOURCES]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(CSRC / name)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for name, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [(name, p.returncode) for name, p in zip(SOURCES, procs) if p.returncode]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode:
            failed.append(("link", link.returncode))
    so.with_suffix(".log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed {failed}:\n" + "".join(logs))
    os.replace(tmp, so)
    return so


def build_log() -> str:
    """nvcc's output (ptxas register and shared-memory report) of the build."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tsdf_error_string.argtypes = [ctypes.c_int]
        lib.tsdf_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().tsdf_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def card_reciprocal(x: float) -> float:
    """1 / x as PyTorch on the card divides a float32 tensor by the Python
    scalar x: a product with the reciprocal, taken in double and rounded to
    float32 (tests/test_torch_kernels_cuda.py pins it where that differs
    from the float32 reciprocal of float32 x)."""
    return float(np.float32(1.0 / x))


def aligned16(*tensors: Optional[torch.Tensor]) -> bool:
    """Every tensor given starts on a 16-byte boundary (the kernels' vector
    loads)."""
    return all(x.data_ptr() % 16 == 0 for x in tensors if x is not None)


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
