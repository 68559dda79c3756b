"""TUM RGB-D dataset reader and writer (counterpart of tracking_sdf_tpu.data.tum).

The standard on-disk layout:

    rgb.txt / depth.txt      "timestamp filename" listings ('#' headers)
    rgb/*.png                8-bit RGB
    depth/*.png              16-bit, depth in meters = value / 5000
    groundtruth.txt          TUM trajectory (timestamp tx ty tz qx qy qz qw)

``TUMDataset.stream`` decodes through the native C++ loader (data.native: a
thread pool that decodes ahead of the consumer) and raises when that library
cannot be built. Indexed access (``ds[i]``) uses the native one-shot decoder
when the library is there and this module's plain decoder otherwise;
``data.native.available()`` says which.

PNG files are written and read here with ``zlib`` and ``struct`` alone: the
writer emits the two kinds a TUM sequence holds (16-bit grayscale with
big-endian samples, 8-bit RGB; non-interlaced, one IDAT), and the plain
decoder reads the native loader's subset (8- or 16-bit gray, gray + alpha,
RGB, RGBA; non-interlaced; all five row filters).
"""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tracking_sdf_tpu_torch.pipeline.trajectory import Trajectory, associate, read_trajectory

DEPTH_SCALE = 5000.0  # TUM convention: png_value / 5000 = meters

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG color type -> channels (no palette)
_MAX_DIM = 16384


# --- PNG ---------------------------------------------------------------------

def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write a (H, W) uint16 array as a 16-bit grayscale PNG, or a (H, W, 3)
    uint8 array as an 8-bit RGB PNG (row filter None, one IDAT, the fastest
    zlib level: a sequence is written once and read a few times)."""
    image = np.asarray(image)
    if image.dtype == np.uint16 and image.ndim == 2:
        bit_depth, color_type = 16, 0
        rows = image.astype(">u2").view(np.uint8).reshape(image.shape[0], -1)
    elif image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3:
        bit_depth, color_type = 8, 2
        rows = image.reshape(image.shape[0], -1)
    else:
        raise ValueError(f"write_png: (H, W) uint16 or (H, W, 3) uint8, got "
                         f"{image.dtype} {image.shape}")
    h, w = image.shape[:2]
    filtered = np.zeros((h, rows.shape[1] + 1), np.uint8)  # filter byte 0 per row
    filtered[:, 1:] = rows
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 1))
                + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Filtered scanlines (a filter byte, then ``stride`` bytes, per row) to
    the (height, stride) image bytes; ``bpp`` is the filter unit in bytes."""
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        start = y * (stride + 1)
        kind = raw[start]
        src = np.frombuffer(raw, np.uint8, stride, start + 1)
        if kind == 0:
            row = src
        elif kind == 1:  # Sub: a running sum per byte lane, modulo 256
            if stride % bpp:
                raise ValueError("PNG row is not a whole number of pixels")
            row = np.cumsum(src.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            row = src + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one before
            s, up, dst = src.tolist(), prev.tolist(), [0] * stride
            for x in range(stride):
                a = dst[x - bpp] if x >= bpp else 0
                if kind == 3:
                    dst[x] = (s[x] + ((a + up[x]) >> 1)) & 0xFF
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    dst[x] = (s[x] + _paeth(a, up[x], c)) & 0xFF
            row = np.asarray(dst, np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind}")
        out[y] = row
        prev = out[y]
    return out


def decode_png(path: str) -> Tuple[np.ndarray, int, int]:
    """The plain PNG decoder: (samples, channels, bit_depth) with samples a
    (H, W, channels) uint8 or uint16 array. Raises ValueError on anything
    outside the subset or corrupt."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_MAGIC:
        raise ValueError(f"not a PNG file: {path}")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(buf):
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        kind = buf[pos + 4:pos + 8]
        if pos + 12 + length > len(buf):
            raise ValueError(f"truncated PNG chunk in {path}")
        payload = buf[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            if length < 13:
                raise ValueError(f"short IHDR in {path}")
            header = struct.unpack(">IIBBBBB", payload[:13])
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"PNG without IHDR or IDAT: {path}")
    w, h, bit_depth, color_type, _, _, interlace = header
    if (interlace or color_type not in _CHANNELS or bit_depth not in (8, 16)
            or not 0 < w <= _MAX_DIM or not 0 < h <= _MAX_DIM):
        raise ValueError(f"unsupported PNG ({w}x{h}, {bit_depth} bit, color type "
                         f"{color_type}, interlace {interlace}): {path}")
    channels = _CHANNELS[color_type]
    bpp = channels * bit_depth // 8
    stride = w * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data in {path}: {e}") from None
    if len(raw) < (stride + 1) * h:
        raise ValueError(f"short PNG data in {path}")
    data = _unfilter(raw, h, stride, bpp)
    if bit_depth == 16:
        data = data.view(">u2").astype(np.uint16)
    return data.reshape(h, w, channels), channels, bit_depth


def decode_depth_png(path: str) -> np.ndarray:
    """16-bit grayscale PNG -> (H, W) uint16 (the plain decoder)."""
    data, channels, bit_depth = decode_png(path)
    if channels != 1 or bit_depth != 16:
        raise ValueError(f"depth PNG must be 16-bit grayscale: {path}")
    return data[..., 0]


def decode_rgb_png(path: str) -> np.ndarray:
    """Any 8-bit PNG of the subset -> (H, W, 3) uint8 (the plain decoder);
    gray is repeated, alpha dropped."""
    data, channels, bit_depth = decode_png(path)
    if bit_depth != 8:
        raise ValueError(f"color PNG must be 8-bit: {path}")
    if channels <= 2:
        return np.repeat(data[..., :1], 3, axis=-1)
    return np.ascontiguousarray(data[..., :3])


def load_depth_png(path: str) -> np.ndarray:
    """16-bit depth PNG -> float32 meters with NaN holes (value 0 = no data),
    by the native decoder when its library is there, else the plain one."""
    from tracking_sdf_tpu_torch.data import native

    if native.available():
        return native.decode_depth(path)
    raw = decode_depth_png(path)
    depth = raw.astype(np.float32) / DEPTH_SCALE
    depth[raw == 0] = np.nan
    return depth


def load_rgb_png(path: str) -> np.ndarray:
    """8-bit RGB PNG -> float32 in [0, 1] (native decoder, else the plain one)."""
    from tracking_sdf_tpu_torch.data import native

    if native.available():
        return native.decode_rgb(path)
    return decode_rgb_png(path).astype(np.float32) / 255.0


# --- the dataset -------------------------------------------------------------

def _read_listing(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            stamp, name = line.split()[:2]
            out.append((float(stamp), name))
    return out


@dataclasses.dataclass
class TUMFrame:
    timestamp: float
    depth: np.ndarray  # (H, W) float32 meters, NaN holes (or raw uint16, 0 = hole)
    rgb: Optional[np.ndarray]  # (H, W, 3) float32 in [0, 1] (or raw uint8) or None
    gt_pose: Optional[Tuple[np.ndarray, np.ndarray]] = None  # (t(3,), q(4,)) if available


class TUMDataset:
    """Random-access and iterable view of a TUM sequence directory. Colors
    and groundtruth poses are associated to depth frames by nearest
    timestamp within ``max_dt`` seconds."""

    def __init__(self, root: str, with_rgb: bool = True, max_dt: float = 0.02):
        self.root = root
        self.with_rgb = with_rgb
        depth_list = _read_listing(os.path.join(root, "depth.txt"))
        self._depth = depth_list
        stamps = np.asarray([t for t, _ in depth_list])
        self._rgb_for_depth: List[Optional[str]] = [None] * len(depth_list)
        if with_rgb and os.path.exists(os.path.join(root, "rgb.txt")):
            rgb_list = _read_listing(os.path.join(root, "rgb.txt"))
            for di, ri in associate(stamps, np.asarray([t for t, _ in rgb_list]),
                                    max_dt=max_dt):
                self._rgb_for_depth[di] = rgb_list[ri][1]
        gt_path = os.path.join(root, "groundtruth.txt")
        self.groundtruth: Optional[Trajectory] = (
            read_trajectory(gt_path) if os.path.exists(gt_path) else None)
        self._gt_for_depth: List[Optional[int]] = [None] * len(depth_list)
        if self.groundtruth is not None:
            for di, gi in associate(stamps, self.groundtruth.timestamps, max_dt=max_dt):
                self._gt_for_depth[di] = gi

    def __len__(self) -> int:
        return len(self._depth)

    def _gt_pose(self, i: int):
        gi = self._gt_for_depth[i]
        if gi is None:
            return None
        g = self.groundtruth
        return g.translations[gi].astype(np.float32), g.quaternions[gi].astype(np.float32)

    def __getitem__(self, i: int) -> TUMFrame:
        depth_path, rgb_path = self.frame_paths(i)
        return TUMFrame(timestamp=self._depth[i][0], depth=load_depth_png(depth_path),
                        rgb=None if rgb_path is None else load_rgb_png(rgb_path),
                        gt_pose=self._gt_pose(i))

    def __iter__(self) -> Iterator[TUMFrame]:
        for i in range(len(self)):
            yield self[i]

    def frame_paths(self, i: int) -> Tuple[str, Optional[str]]:
        """Absolute (depth_path, rgb_path or None) of frame i."""
        d = os.path.join(self.root, self._depth[i][1])
        r = self._rgb_for_depth[i] if self.with_rgb else None
        return d, (os.path.join(self.root, r) if r is not None else None)

    def stream(self, prefetch: int = 8, threads: int = 0, raw: bool = False,
               indices: Optional[Sequence[int]] = None) -> Iterator[TUMFrame]:
        """Iterate the frames (or those of ``indices``) through the native
        prefetching loader, which decodes ahead on a thread pool. Raises
        (data.native.NativeLoaderError, with the compiler's output) when the
        library cannot be built: nothing else decodes in its place.

        ``raw=True`` yields the TUM wire formats (depth uint16 with 0 =
        hole, rgb uint8): a sixth of the bytes for the chunked runner, which
        decodes on the device; the per-frame path decodes them too."""
        from tracking_sdf_tpu_torch.data import native

        idx = list(range(len(self))) if indices is None else list(indices)
        paths = [self.frame_paths(i) for i in idx]
        loader = native.PrefetchingLoader(
            [d for d, _ in paths], [r for _, r in paths] if self.with_rgb else None,
            prefetch=prefetch, threads=threads, raw=raw)
        return self._stream(loader, idx)

    def _stream(self, loader, idx: List[int]) -> Iterator[TUMFrame]:
        with loader:
            for k, depth, rgb in loader:
                i = idx[k]
                yield TUMFrame(timestamp=self._depth[i][0], depth=depth, rgb=rgb,
                               gt_pose=self._gt_pose(i))


def write_synthetic_tum(root: str, depths: List[np.ndarray],
                        rgbs: Optional[List[np.ndarray]] = None,
                        poses: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None,
                        t0: float = 1000.0, dt: float = 1.0 / 30.0) -> None:
    """Write arrays as an on-disk TUM sequence: depth in meters (NaN holes)
    rounded to the 1/5000 m steps, colors in [0, 1] scaled by 255 and
    truncated, poses as (t, q) lines of groundtruth.txt."""
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    if rgbs is not None:
        os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    depth_lines, rgb_lines, gt_lines = [], [], []
    for i, depth in enumerate(depths):
        stamp = t0 + i * dt
        # round, not truncate: truncation would bias every depth low by up
        # to one step (0.2 mm)
        raw = np.nan_to_num(np.asarray(depth), nan=0.0) * DEPTH_SCALE
        raw = np.clip(np.round(raw), 0, 65535).astype(np.uint16)
        name = f"depth/{stamp:.6f}.png"
        write_png(os.path.join(root, name), raw)
        depth_lines.append(f"{stamp:.6f} {name}")
        if rgbs is not None:
            img = np.clip(np.asarray(rgbs[i]) * 255.0, 0, 255).astype(np.uint8)
            rname = f"rgb/{stamp:.6f}.png"
            write_png(os.path.join(root, rname), img)
            rgb_lines.append(f"{stamp:.6f} {rname}")
        if poses is not None:
            t, q = poses[i]
            gt_lines.append(
                f"{stamp:.6f} " + " ".join(f"{v:.6f}" for v in list(t) + list(q)))
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("# depth maps\n# file: synthetic\n# timestamp filename\n")
        f.write("\n".join(depth_lines) + "\n")
    if rgb_lines:
        with open(os.path.join(root, "rgb.txt"), "w") as f:
            f.write("# color images\n# file: synthetic\n# timestamp filename\n")
            f.write("\n".join(rgb_lines) + "\n")
    if gt_lines:
        with open(os.path.join(root, "groundtruth.txt"), "w") as f:
            f.write("# ground truth trajectory\n# file: synthetic\n"
                    "# timestamp tx ty tz qx qy qz qw\n")
            f.write("\n".join(gt_lines) + "\n")
