"""The port's TUM ingestion: its PNG writer and plain decoder, the native
loader's binding and TUMDataset, against PIL, against the native decoder and
against the JAX package's data.tum on the same directories.

Tolerance: bitwise everywhere (the same integers, and float32 decodes by the
same true divisions).
"""
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from tracking_sdf_tpu.data import tum as jtum
from tracking_sdf_tpu_torch.data import native, tum

H, W, N = 48, 64, 6


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    depths, rgbs, poses = [], [], []
    for i in range(N):
        d = rng.uniform(0.4, 4.0, size=(H, W)).astype(np.float32)
        d[rng.random((H, W)) < 0.15] = np.nan
        depths.append(d)
        rgbs.append(rng.random((H, W, 3)).astype(np.float32))
        q = rng.normal(size=4)
        poses.append((rng.normal(size=3).astype(np.float32),
                      (q / np.linalg.norm(q)).astype(np.float32)))
    return depths, rgbs, poses


@pytest.fixture(scope="module")
def seq(tmp_path_factory, frames):
    """The same frames written by the port and by the JAX package (PIL)."""
    roots = {}
    for name, write in (("port", tum.write_synthetic_tum), ("jax", jtum.write_synthetic_tum)):
        roots[name] = str(tmp_path_factory.mktemp(f"tum_{name}"))
        write(roots[name], *frames)
    return roots


def listing(root, name):
    return [os.path.join(root, n) for _, n in tum._read_listing(os.path.join(root, name))]


def test_native_library_builds():
    """With g++, make and zlib installed (as wherever these tests run) the
    binding must build and load."""
    assert native.available()
    native.load_library()


@pytest.mark.parametrize("kind", ["depth", "rgb"])
def test_written_png_reads_back_bitwise(seq, frames, kind):
    """The port's writer read by PIL, by the native decoder and by the plain
    decoder: the integers the writer was given, and the float32 decodes of
    data.tum's loaders."""
    depths, rgbs, _ = frames
    for i, path in enumerate(listing(seq["port"], f"{kind}.txt")):
        if kind == "depth":
            want = np.clip(np.round(np.nan_to_num(depths[i], nan=0.0) * 5000.0),
                           0, 65535).astype(np.uint16)
            plain = tum.decode_depth_png(path)
            want_f = want.astype(np.float32) / 5000.0
            want_f[want == 0] = np.nan
            got_f = native.decode_depth(path)
            pil = np.asarray(Image.open(path))
        else:
            want = np.clip(rgbs[i] * 255.0, 0, 255).astype(np.uint8)
            plain = tum.decode_rgb_png(path)
            want_f = want.astype(np.float32) / 255.0
            got_f = native.decode_rgb(path)
            pil = np.asarray(Image.open(path).convert("RGB"))
        assert plain.dtype == want.dtype
        np.testing.assert_array_equal(pil, want)
        np.testing.assert_array_equal(plain, want)
        np.testing.assert_array_equal(got_f.view(np.int32), want_f.view(np.int32))


def test_files_equal_the_jax_writers(seq):
    """The listings and groundtruth of both writers are the same text, and
    every PNG holds the same pixels."""
    for name in ("depth.txt", "rgb.txt", "groundtruth.txt"):
        with open(os.path.join(seq["port"], name)) as a, open(os.path.join(seq["jax"], name)) as b:
            assert a.read() == b.read(), name
    for name in ("depth.txt", "rgb.txt"):
        for a, b in zip(listing(seq["port"], name), listing(seq["jax"], name)):
            np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "plain"])
def test_dataset_matches_jax(seq, monkeypatch, use_native):
    """A directory the JAX package wrote (PIL's row filters) gives the same
    frames, associations and groundtruth through both packages' TUMDataset,
    with the port decoding natively or by its plain decoder."""
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    dj, dt = jtum.TUMDataset(seq["jax"]), tum.TUMDataset(seq["jax"])
    assert len(dj) == len(dt) == N
    np.testing.assert_array_equal(dt.groundtruth.timestamps, dj.groundtruth.timestamps)
    np.testing.assert_array_equal(dt.groundtruth.translations, dj.groundtruth.translations)
    np.testing.assert_array_equal(dt.groundtruth.quaternions, dj.groundtruth.quaternions)
    for i, (fj, ft) in enumerate(zip(dj, dt)):
        assert ft.timestamp == fj.timestamp
        assert dt.frame_paths(i) == dj.frame_paths(i)
        assert ft.depth.dtype == ft.rgb.dtype == np.float32
        np.testing.assert_array_equal(ft.depth.view(np.int32), fj.depth.view(np.int32))
        np.testing.assert_array_equal(ft.rgb, fj.rgb)
        np.testing.assert_array_equal(ft.gt_pose[0], fj.gt_pose[0])
        np.testing.assert_array_equal(ft.gt_pose[1], fj.gt_pose[1])


def test_association_gaps_match_jax(tmp_path, frames):
    """Color and groundtruth stamps off by more than max_dt stay unmatched,
    in both packages alike; with_rgb=False reads no color."""
    depths, rgbs, poses = frames
    root = str(tmp_path / "gaps")
    tum.write_synthetic_tum(root, depths, rgbs, poses)
    for name, keep in (("rgb.txt", lambda i: i != 2), ("groundtruth.txt", lambda i: i != 5)):
        path = os.path.join(root, name)
        with open(path) as f:
            lines = f.read().splitlines()
        head = [x for x in lines if x.startswith("#")]
        body = [x for x in lines if not x.startswith("#")]
        body = [x for i, x in enumerate(body) if keep(i)]
        # frame 1's line moves 15 ms (inside max_dt), frame 3's 25 ms (outside)
        for i, shift in ((1, 0.015), (3 if name == "groundtruth.txt" else 2, 0.025)):
            parts = body[i].split()
            parts[0] = f"{float(parts[0]) + shift:.6f}"
            body[i] = " ".join(parts)
        with open(path, "w") as f:
            f.write("\n".join(head + body) + "\n")
    dj, dt = jtum.TUMDataset(root), tum.TUMDataset(root)
    assert dt._rgb_for_depth == dj._rgb_for_depth and dt._gt_for_depth == dj._gt_for_depth
    assert sum(r is None for r in dt._rgb_for_depth) == 2
    assert sum(g is None for g in dt._gt_for_depth) == 2
    f1, f3 = dt[1], dt[3]
    assert f1.rgb is not None and f1.gt_pose is not None
    assert f3.rgb is None and f3.gt_pose is None and dt[5].gt_pose is None
    no_rgb = tum.TUMDataset(root, with_rgb=False)
    assert no_rgb[0].rgb is None and no_rgb.frame_paths(0)[1] is None


def _filtered_png(tmp_path, image, filters):
    """A PNG of ``image`` ((H, W) uint16 or (H, W, 3) uint8) whose row y is
    filtered with kind ``filters[y % len(filters)]``, made here byte by byte."""
    if image.dtype == np.uint16:
        rows = image.astype(">u2").view(np.uint8).reshape(image.shape[0], -1)
        bpp, bit_depth, color_type = 2, 16, 0
    else:
        rows = image.reshape(image.shape[0], -1)
        bpp, bit_depth, color_type = 3, 8, 2
    rows = rows.astype(np.int64)
    out = bytearray()
    for y in range(rows.shape[0]):
        kind = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(kind)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
    h, w = image.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    path = str(tmp_path / f"f{''.join(map(str, filters))}_{bit_depth}.png")
    with open(path, "wb") as f:
        f.write(tum._PNG_MAGIC + tum._chunk(b"IHDR", ihdr)
                + tum._chunk(b"IDAT", zlib.compress(bytes(out))) + tum._chunk(b"IEND", b""))
    return path


@pytest.mark.parametrize("filters", [(1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["sub", "up", "average", "paeth", "mixed"])
def test_row_filters_decode_equally(tmp_path, filters):
    """Rows filtered Sub, Up, Average and Paeth: the plain decoder, the
    native decoder and PIL read the same pixels, 16-bit gray and 8-bit RGB."""
    rng = np.random.default_rng(7)
    d16 = rng.integers(0, 65536, size=(20, 33), dtype=np.uint16)
    c8 = rng.integers(0, 256, size=(20, 33, 3), dtype=np.uint8)
    pd, pc = _filtered_png(tmp_path, d16, filters), _filtered_png(tmp_path, c8, filters)
    np.testing.assert_array_equal(np.asarray(Image.open(pd)), d16)
    np.testing.assert_array_equal(np.asarray(Image.open(pc)), c8)
    np.testing.assert_array_equal(tum.decode_depth_png(pd), d16)
    np.testing.assert_array_equal(tum.decode_rgb_png(pc), c8)
    want = d16.astype(np.float32) / 5000.0
    want[d16 == 0] = np.nan
    np.testing.assert_array_equal(native.decode_depth(pd).view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(native.decode_rgb(pc), c8.astype(np.float32) / 255.0)


def test_pil_written_filters_and_layouts(tmp_path):
    """What PIL writes for a smooth image (its adaptive filters), and the
    8-bit gray and RGBA layouts: plain and native decoders agree with PIL."""
    ys, xs = np.mgrid[0:40, 0:56]
    smooth = (2000 + 30 * xs + 17 * ys + 5 * np.sin(xs / 3.0)).astype(np.uint16)
    p16 = str(tmp_path / "smooth16.png")
    Image.fromarray(smooth).save(p16)
    np.testing.assert_array_equal(tum.decode_depth_png(p16), smooth)
    rgba = np.stack([xs * 4, ys * 6, xs + ys, 255 - xs], axis=-1).astype(np.uint8)
    for mode, arr in (("RGBA", rgba), ("RGB", rgba[..., :3]), ("L", rgba[..., 0])):
        path = str(tmp_path / f"{mode}.png")
        Image.fromarray(arr, mode=mode).save(path)
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(tum.decode_rgb_png(path), want)
        np.testing.assert_array_equal(native.decode_rgb(path), want.astype(np.float32) / 255.0)
    with pytest.raises(ValueError):
        tum.decode_depth_png(str(tmp_path / "RGB.png"))
    with pytest.raises(ValueError):
        tum.decode_rgb_png(p16)


def _raw_png(w, h, bit_depth=16, color_type=0, payload=b"\x00" * 10, interlace=0):
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, interlace)
    return (tum._PNG_MAGIC + tum._chunk(b"IHDR", ihdr)
            + tum._chunk(b"IDAT", zlib.compress(payload)) + tum._chunk(b"IEND", b""))


@pytest.mark.parametrize("case", ["huge", "overflow", "trunc", "zero", "short", "palette",
                                  "interlaced", "garbage", "bad_filter", "not_png"])
def test_corrupt_png_raises(tmp_path, case):
    """Corrupt or unsupported files raise from both decoders and crash
    neither. (A stream that ends early, "short", is the one the native
    decoder lets pass, zero-filled; the plain decoder raises on it.)"""
    data = {
        "huge": _raw_png(1 << 30, 1 << 30),
        "overflow": _raw_png(65535, 65535),
        "trunc": _raw_png(64, 48)[:20],
        "zero": _raw_png(0, 0),
        "short": _raw_png(64, 48),
        "palette": _raw_png(4, 4, 8, 3, b"\x00" * 20),
        "interlaced": _raw_png(4, 4, 16, 0, b"\x00" * 36, interlace=1),
        "garbage": _raw_png(4, 4)[:-30] + b"\x00" * 30,
        "bad_filter": _raw_png(4, 4, 16, 0, b"\x07" * 36),
        "not_png": b"P5 4 4 255 " + b"\x00" * 16,
    }[case]
    path = tmp_path / f"{case}.png"
    path.write_bytes(data)
    with pytest.raises(ValueError):
        tum.decode_depth_png(str(path))
    if case == "short":
        assert native.decode_depth(str(path)).shape == (48, 64)
        return
    with pytest.raises(ValueError):
        native.decode_depth(str(path))


def test_prefetching_loader_ordered_and_complete(seq):
    dp, rp = listing(seq["port"], "depth.txt"), listing(seq["port"], "rgb.txt")
    with native.PrefetchingLoader(dp, rp, prefetch=3, threads=4) as ld:
        assert (ld.width, ld.height) == (W, H)
        got = list(ld)
    assert [i for i, _, _ in got] == list(range(N))
    for i, depth, rgb in got:
        want = native.decode_depth(dp[i])
        np.testing.assert_array_equal(depth.view(np.int32), want.view(np.int32))
        np.testing.assert_array_equal(rgb, native.decode_rgb(rp[i]))


def test_prefetching_loader_depth_only(seq):
    dp = listing(seq["port"], "depth.txt")
    with native.PrefetchingLoader(dp, None, prefetch=2, threads=2) as ld:
        got = list(ld)
    assert [i for i, _, _ in got] == list(range(N))
    assert all(rgb is None for _, _, rgb in got)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_prefetching_loader_raw_mode(seq, source):
    """raw=True yields the wire formats, equal to the plain decoder's."""
    dp, rp = listing(seq[source], "depth.txt"), listing(seq[source], "rgb.txt")
    with native.PrefetchingLoader(dp, rp, raw=True) as ld:
        got = list(ld)
    assert [i for i, _, _ in got] == list(range(N))
    for i, d16, c8 in got:
        assert d16.dtype == np.uint16 and c8.dtype == np.uint8
        np.testing.assert_array_equal(d16, tum.decode_depth_png(dp[i]))
        np.testing.assert_array_equal(c8, tum.decode_rgb_png(rp[i]))


def test_loader_skips_an_undecodable_frame(seq, tmp_path):
    dp = listing(seq["port"], "depth.txt")
    bad = tmp_path / "bad.png"
    bad.write_bytes(_raw_png(W, H)[:40])
    paths = dp[:2] + [str(bad)] + dp[3:]
    with native.PrefetchingLoader(paths, None) as ld:
        assert [i for i, _, _ in ld] == [0, 1, 3, 4, 5]
    with pytest.raises(RuntimeError):
        native.PrefetchingLoader([str(bad)] + dp[1:], None)


@pytest.mark.parametrize("raw", [False, True], ids=["float", "raw"])
def test_stream_matches_indexed_access(seq, raw):
    """stream() (and a subset of indices) against ds[i]: timestamps,
    groundtruth and pixels."""
    ds = tum.TUMDataset(seq["port"])
    for indices in (None, [0, 2, 4]):
        got = list(ds.stream(prefetch=2, threads=2, raw=raw, indices=indices))
        idx = list(range(N)) if indices is None else indices
        assert len(got) == len(idx)
        for f, i in zip(got, idx):
            ref = ds[i]
            assert f.timestamp == ref.timestamp
            np.testing.assert_array_equal(f.gt_pose[0], ref.gt_pose[0])
            if raw:
                want = f.depth.astype(np.float32) / 5000.0
                want[f.depth == 0] = np.nan
                np.testing.assert_array_equal(want.view(np.int32), ref.depth.view(np.int32))
                np.testing.assert_array_equal(f.rgb.astype(np.float32) / 255.0, ref.rgb)
            else:
                np.testing.assert_array_equal(f.depth.view(np.int32), ref.depth.view(np.int32))
                np.testing.assert_array_equal(f.rgb, ref.rgb)


def test_no_quiet_fallback_when_the_library_cannot_be_built(seq, tmp_path, monkeypatch):
    """With a source that does not compile, and a library left from an older
    build beside it: stream(), PrefetchingLoader and the one-shot decoders
    raise with the compiler's words and never load the old library; only the
    indexed loaders go on, through the plain decoder."""
    import shutil

    good = native.load_library()
    broken = tmp_path / "native"
    broken.mkdir()
    shutil.copy(os.path.join(native._NATIVE_DIR, "Makefile"), broken)
    shutil.copy(os.path.join(native._NATIVE_DIR, native._SO_NAME), broken)  # the stale one
    (broken / "loader.cpp").write_text("#error this loader does not compile\n")
    os.utime(broken / native._SO_NAME, (1, 1))
    monkeypatch.setattr(native, "_NATIVE_DIR", str(broken))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    ds = tum.TUMDataset(seq["port"])
    with pytest.raises(native.NativeLoaderError, match="does not compile"):
        ds.stream()
    with pytest.raises(native.NativeLoaderError, match="does not compile"):
        native.PrefetchingLoader(listing(seq["port"], "depth.txt"))
    with pytest.raises(native.NativeLoaderError):
        native.decode_depth(listing(seq["port"], "depth.txt")[0])
    assert native._lib is None and not native.available()
    plain = ds[1]
    monkeypatch.undo()
    assert native.load_library() is good
    ref = tum.TUMDataset(seq["port"])[1]
    np.testing.assert_array_equal(plain.depth.view(np.int32), ref.depth.view(np.int32))
    np.testing.assert_array_equal(plain.rgb, ref.rgb)
