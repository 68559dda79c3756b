"""Depth preprocessing (K3 bilateral filters, K4 backprojection and normals):
the plain versions against the JAX package, the CPU dispatch, the wrappers'
argument checks and the C signatures of every kernel entry point; through a
stand-in kernel library, the arguments the wrappers pass (the 16-byte flag
only for w % 4 == 0 and aligned tensors, the weights, one launch a
separable filter), and the wrappers' copies of the kernels' constants.

Inputs are made with numpy from a seed: a tilted plane with a depth jump,
noise, NaN speckle, zero and negative depth and an all-NaN row, at 48x64,
at a ragged 37x53 and at 7x9 (smaller than the 11x11 window). Tolerance, as
tests/test_torch_core.py: atol 1e-5 with equal NaN masks (the two
frameworks' exp differ by an ulp). The kernels themselves run only on a
card: tests/test_torch_kernels_cuda.py and chip_smoke.py phase 12.
"""
import ctypes
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_sdf_tpu.core import camera as jcam
from tracking_sdf_tpu.tracking import preprocess as jpre
from tracking_sdf_tpu_torch.core import camera as tcam
from tracking_sdf_tpu_torch.kernels import _build
from tracking_sdf_tpu_torch.tracking import preprocess as tpre

torch.set_num_threads(2)

ATOL = 1e-5
SIZES = [(48, 64), (37, 53), (7, 9)]


def _cam(h, w):
    return tcam.PinholeCamera(fx=0.9 * w, fy=0.9 * w, cx=(w - 1) / 2, cy=(h - 1) / 2,
                              width=w, height=h)


def _depth(h, w, seed=0):
    rng = np.random.default_rng(seed + 100 * h + w)
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    d = 1.2 + 0.004 * u + 0.002 * v + 0.2 * (u > w // 2)  # a depth jump
    d = d + rng.normal(scale=0.005, size=d.shape)
    r = rng.random(d.shape)
    d[r < 0.05] = np.nan
    d[(r >= 0.05) & (r < 0.06)] = 0.0
    d[(r >= 0.06) & (r < 0.07)] = -0.5
    d[h // 3] = np.nan
    return d.astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("form", ["separable", "full"])
def test_bilateral_reference_matches_jax(form, h, w):
    d = _depth(h, w)
    if form == "separable":
        want = jpre.bilateral_filter_separable(jnp.asarray(d))
        got = tpre.bilateral_filter_separable_reference(torch.from_numpy(d))
    else:
        want = jpre.bilateral_filter(jnp.asarray(d))
        got = tpre.bilateral_filter_reference(torch.from_numpy(d))
    _close(got, want)
    assert np.isfinite(_np(got)).any()


@pytest.mark.parametrize("h,w", SIZES)
def test_normals_reference_matches_jax(h, w):
    d = _depth(h, w)
    cam = _cam(h, w)
    pj = jcam.backproject(jcam.PinholeCamera(*cam), jnp.asarray(d))
    pt = tcam.backproject(cam, torch.from_numpy(d))
    _close(pt, pj)
    _close(tpre.estimate_normals_reference(pt), jpre.estimate_normals(pj))


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("mode", ["separable", "full"])
def test_preprocess_frame_matches_jax(mode, h, w):
    d = _depth(h, w, seed=1)
    cam = _cam(h, w)
    pj, nj = jpre.preprocess_frame(jnp.asarray(d), cam=jcam.PinholeCamera(*cam),
                                   bilateral_mode=mode)
    pt, nt = tpre.preprocess_frame(torch.from_numpy(d), cam=cam, bilateral_mode=mode)
    _close(pt, pj)
    _close(nt, nj)
    if h > 10:
        assert np.isfinite(_np(nt)).all(-1).mean() > 0.3


@pytest.mark.parametrize("form", ["separable", "normals"])
def test_references_take_radii_past_the_image(form):
    """Radii larger than the 7x9 image (every tap of some shifts lies
    outside it) against the JAX package."""
    d = _depth(7, 9)
    if form == "separable":
        want = jpre.bilateral_filter_separable(jnp.asarray(d), radius=12)
        got = tpre.bilateral_filter_separable_reference(torch.from_numpy(d), 12)
    else:
        cam = _cam(7, 9)
        pj = jcam.backproject(jcam.PinholeCamera(*cam), jnp.asarray(d))
        want = jpre.estimate_normals(pj, smoothing_radius=10)
        got = tpre.estimate_normals_reference(tcam.backproject(cam, torch.from_numpy(d)),
                                              tpre.DEPTH_CHANGE_FACTOR, 10)
    _close(got, want)
    assert np.isfinite(_np(got)).any()


def test_bilateral_pass_reference_composes_the_separable_filter():
    d = torch.from_numpy(_depth(37, 53))
    two = tpre.bilateral_pass_reference(tpre.bilateral_pass_reference(d, 0), 1)
    assert torch.equal(torch.isnan(two), torch.isnan(tpre.bilateral_filter_separable(d)))
    both = ~torch.isnan(two)
    assert torch.equal(two[both], tpre.bilateral_filter_separable(d)[both])


def _counts():
    return tpre.launches_pass, tpre.launches_2d, tpre.launches_normals


CPU_CALLS = {
    "bilateral_filter": (lambda d, cam: tpre.bilateral_filter(d),
                         lambda d, cam: tpre.bilateral_filter_reference(d)),
    "bilateral_filter_separable": (lambda d, cam: tpre.bilateral_filter_separable(d),
                                   lambda d, cam: tpre.bilateral_filter_separable_reference(d)),
    "bilateral_pass": (lambda d, cam: tpre.bilateral_pass(d, 1),
                       lambda d, cam: tpre.bilateral_pass_reference(d, 1)),
    "estimate_normals": (
        lambda d, cam: tpre.estimate_normals(tcam.backproject(cam, d)),
        lambda d, cam: tpre.estimate_normals_reference(tcam.backproject(cam, d))),
    "preprocess_frame_separable": (
        lambda d, cam: tpre.preprocess_frame(d, cam=cam, bilateral_mode="separable"),
        lambda d, cam: (lambda p: (p, tpre.estimate_normals_reference(p)))(
            tcam.backproject(cam, tpre.bilateral_filter_separable_reference(d)))),
    "preprocess_frame_full": (
        lambda d, cam: tpre.preprocess_frame(d, cam=cam),
        lambda d, cam: (lambda p: (p, tpre.estimate_normals_reference(p)))(
            tcam.backproject(cam, tpre.bilateral_filter_reference(d)))),
    "preprocess_frame_unfiltered": (
        lambda d, cam: tpre.preprocess_frame(d, cam=cam, bilateral=False),
        lambda d, cam: (lambda p: (p, tpre.estimate_normals_reference(p)))(
            tcam.backproject(cam, d))),
}


@pytest.mark.parametrize("name", list(CPU_CALLS))
def test_cpu_dispatch_is_the_plain_version(name, monkeypatch):
    """On the CPU the public names return the plain version's bits and never
    reach the kernel library; no launch is counted."""
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_build, "library", no_library)
    d = torch.from_numpy(_depth(37, 53, seed=2))
    cam = _cam(37, 53)
    before = _counts()
    call, plain = CPU_CALLS[name]
    got, want = call(d, cam), plain(d, cam)
    assert _counts() == before
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(a.nan_to_num().view(torch.int32), b.nan_to_num().view(torch.int32))


@pytest.mark.parametrize("bad", ["float64", "3-D", "non-contiguous"])
def test_argument_check_rejects(bad):
    """What the kernels are given: the wrong rank or channel count and a
    dtype that is not floating raise; a float64 or non-contiguous image
    becomes a contiguous float32 copy with the values the plain version sees
    on the float32 image; a contiguous float32 image is passed as it is."""
    d = torch.from_numpy(_depth(8, 12))
    for x in (d, torch.zeros(8, 12, 3)):
        assert tpre._card_image(x, "x", channels=3 if x.dim() == 3 else 0) is x
    if bad == "3-D":
        for x, ch in ((d[None], 0), (d, 3), (torch.zeros(8, 12, 2), 3), (d.to(torch.int32), 0)):
            with pytest.raises(ValueError):
                tpre._card_image(x, "x", channels=ch)
        return
    x, want = {"float64": (d.double(), d),
               "non-contiguous": (d.t(), d.t().contiguous())}[bad]
    got = tpre._card_image(x, "depth")
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got.nan_to_num().view(torch.int32), want.nan_to_num().view(torch.int32))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    pts = torch.from_numpy(np.stack([_depth(12, 8)] * 3, -1)).transpose(0, 1)
    got = tpre._card_image(pts if bad == "non-contiguous" else pts.contiguous().double(),
                           "points", channels=3)
    assert got.is_contiguous() and torch.equal(got.nan_to_num(), pts.nan_to_num())


def test_other_devices_raise():
    d = torch.empty(8, 12, device="meta")
    for fn in (tpre.bilateral_filter, tpre.bilateral_filter_separable):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(d)
    with pytest.raises(ValueError, match="unsupported device"):
        tpre.preprocess_frame(d, cam=_cam(8, 12), bilateral=False)


def test_chunk_counts_the_preprocessing_launches():
    from tracking_sdf_tpu_torch.pipeline import chunk

    names = {(mod.__name__, attr) for mod, attr in chunk._COUNTERS}
    for attr in ("launches_pass", "launches_2d", "launches_normals"):
        assert (tpre.__name__, attr) in names


def _extern_c_arity():
    """{entry point: argument count} of every ``extern "C" int`` in csrc/*.cu."""
    out = {}
    for src in sorted(Path(_build.CSRC).glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            args = [a for a in m.group(2).split(",") if a.strip()]
            out[m.group(1)] = len(args)
    return out


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_matches_the_c_entry_point(name):
    """A short argtypes list would cut a pointer: each entry has exactly as
    many arguments as its C function."""
    arity = _extern_c_arity()
    assert name in arity, f"{name} has no extern \"C\" function in csrc/"
    assert len(_build._SIGNATURES[name]) == arity[name]


def test_every_entry_point_has_a_signature():
    assert set(_extern_c_arity()) == set(_build._SIGNATURES)
    assert set(_build.SOURCES) == {p.name for p in Path(_build.CSRC).glob("*.cu")}


def test_preprocess_constants_match_the_source():
    """The wrappers' copies of csrc/preprocess.cu's radii, tiles and pixels a
    thread; the compiled radii are the defaults the presets run; each
    kernel's largest radius is the last whose staged tile fits the 227 KB of
    shared memory an H100 block may have (K3 2-D: the tile with r rows above
    and below, r rounded up to 4 columns left and right; K3 separable: that
    and pass 1's rows; K4 from points: three point planes of the tile plus R
    + 1 and seven planes of tangents and masks), as the source computes them
    from its tiles (tests/test_torch_kernels_cuda.py holds the entry points
    to the same radii on a card)."""
    import inspect

    src = (Path(_build.CSRC) / "preprocess.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["k2dRadius"] == tpre.RADIUS_2D <= tpre.MAX_RADIUS_2D
    assert const["kSepRadius"] == tpre.SEP_RADIUS
    assert const["kBoxRadius"] == tpre.SMOOTHING_RADIUS <= tpre.MAX_BOX_RADIUS
    assert (const["k2dH"], const["k2dW"]) == tpre.TILE_2D
    assert const["k2dPx"] == tpre.PIXELS_2D in (2, 4)
    assert (const["kSepH"], const["kSepW"]) == tpre.SEP_TILE
    assert (const["kNormH"], const["kNormW"]) == tpre.NORMALS_TILE
    assert tpre.SEP_TILE[1] % 4 == 0 and tpre.NORMALS_TILE[1] % 4 == 0
    assert tpre.TILE_2D[1] % (2 * tpre.PIXELS_2D) == 0
    smem, pad4 = 227 * 1024, lambda r: (r + 3) & ~3
    (th, tw), (sh, sw) = tpre.TILE_2D, tpre.SEP_TILE
    nh, nw = tpre.NORMALS_TILE

    def normals(r):
        stage = 3 * (nh + 2 * r + 2) * (nw + 2 * ((r + 4) & ~3))
        return 4 * (stage + 7 * (nh + 2 * r) * (nw + pad4(2 * r)))

    for limit, floats in ((tpre.MAX_RADIUS_2D, lambda r: 4 * (th + 2 * r) * (tw + 2 * pad4(r))),
                          (tpre.MAX_RADIUS_PASS,
                           lambda r: 4 * (2 * sh + 2 * r) * (sw + 2 * pad4(r))),
                          (tpre.MAX_BOX_RADIUS, normals)):
        assert floats(limit) <= smem < floats(limit + 1), limit
    assert "kMaxSmem = 227 * 1024;" in src
    for fn, radius in ((tpre.bilateral_filter, tpre.RADIUS_2D),
                       (tpre.bilateral_filter_separable, tpre.SEP_RADIUS)):
        assert inspect.signature(fn).parameters["radius"].default == radius
    modes = re.search(r"mode 0 / 1: one pass along axis 0 / 1; 2: the separable", src)
    assert modes and (tpre._PASS_AXIS0, tpre._PASS_AXIS1, tpre._PASS_SEPARABLE) == (0, 1, 2)


class _FakeLibrary:
    """Records each entry point's arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_card(monkeypatch):
    """A stand-in kernel library, and CPU tensors taken as card tensors."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(tpre, "_on_card", lambda x, what: True)
    return lib


def _offset(x):
    """A contiguous copy of x that starts 4 bytes past a 16-byte boundary."""
    buf = torch.zeros(x.numel() + 4, dtype=x.dtype)
    start = next(k for k in range(4) if (buf.data_ptr() + 4 * k) % 16 == 4)
    y = buf[start:start + x.numel()].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.parametrize("case", ["aligned", "w % 4", "offset"])
def test_preprocess_wrappers_take_vector_access_only_when_aligned(case, fake_card):
    """K3 (both forms) and K4 (from depth and from points) are asked for
    16-byte loads and stores only where the width is a multiple of 4 and
    every tensor they touch is 16-byte aligned; the arguments follow the C
    signatures, the spatial weights arrive as host floats, and the 2-D form
    is given the radius it compiles by default."""
    h, w = (37, 53) if case == "w % 4" else (48, 64)
    d = torch.from_numpy(_depth(h, w))
    if case == "offset":
        d = _offset(d)
    assert d.is_contiguous() and tpre.aligned16(d) == (case != "offset")
    vec = int(case == "aligned")
    lib = fake_card

    def last(name):
        got, args = lib.calls[-1]
        assert got == name and len(args) == len(_build._SIGNATURES[name])
        return args

    # the compiled radius's weights by value, one a squared tap distance,
    # each the plain version's at every tap of that distance; any radius's
    # (2r+1)^2 table of the plain version on the device
    sw = tpre._spatial_weights(5, 3.0, torch.device("cpu"))
    for r in (tpre.RADIUS_2D, 7):
        tpre.bilateral_filter(d, radius=r)
        args = last("tsdf_bilateral_2d")
        assert args[2:5] == (h, w, r) and args[8] == vec
        weights = list((ctypes.c_float * 51).from_address(args[5]))
        assert all(weights[dy * dy + dx * dx] == float(sw[dy + 5, dx + 5])
                   for dy in range(-5, 6) for dx in range(-5, 6))
        assert args[6] == tpre._spatial_weights(r, 3.0, torch.device("cpu")).data_ptr()
        assert args[7] == 1.0 / (2.0 * 0.03 ** 2)
    for mode in (0, 1, 2):
        tpre._bilateral_pass(d, mode, 5, 3.0, 0.03, "test")
        args = last("tsdf_bilateral_pass")
        assert args[2:6] == (h, w, mode, 5) and args[8] == vec
        weights = list((ctypes.c_float * 11).from_address(args[6]))
        assert weights == [float(np.float32(math.exp(-(k * k) * (1.0 / 18.0))))
                           for k in range(-5, 6)]
    tpre._bilateral_pass(d, 2, 3, 3.0, 0.03, "test")
    assert last("tsdf_bilateral_pass")[4:6] == (2, 3)
    cam = _cam(h, w)
    pts = torch.empty(h, w, 3)
    tpre._normals(d, pts, cam, 0.02, 4, "test")
    args = last("tsdf_normals")
    assert args[3:5] == (h, w) and args[10:12] == (4, vec)
    given = _offset(tcam.backproject(cam, d)) if case == "offset" else tcam.backproject(cam, d)
    tpre._normals(None, given, None, 0.02, 3, "test")
    args = last("tsdf_normals")
    assert args[0] is None and args[10:12] == (3, vec)


def test_separable_filter_on_the_card_is_one_launch(fake_card):
    """On a card tensor bilateral_filter_separable makes one K3 launch (both
    passes), preprocess_frame one K3 and one K4 launch in either mode (the
    2-D form at its compiled radius); bilateral_pass one K3 launch for its
    axis. A radius up to a kernel's largest launches it; one past it, a
    negative radius and a bad axis raise and launch nothing."""
    d = torch.from_numpy(_depth(48, 64))
    before = _counts()
    tpre.bilateral_filter_separable(d)
    assert _counts() == (before[0] + 1, before[1], before[2])
    assert [c[0] for c in fake_card.calls] == ["tsdf_bilateral_pass"]
    assert fake_card.calls[0][1][4] == tpre._PASS_SEPARABLE
    tpre.preprocess_frame(d, cam=_cam(48, 64), bilateral_mode="separable")
    assert _counts() == (before[0] + 2, before[1], before[2] + 1)
    tpre.bilateral_pass(d, 1)
    assert fake_card.calls[-1][1][4] == tpre._PASS_AXIS1 and _counts()[0] == before[0] + 3
    tpre.preprocess_frame(d, cam=_cam(48, 64))
    assert [c[0] for c in fake_card.calls[-2:]] == ["tsdf_bilateral_2d", "tsdf_normals"]
    assert fake_card.calls[-2][1][4] == tpre.RADIUS_2D
    assert _counts() == (before[0] + 3, before[1] + 1, before[2] + 2)
    pts = tcam.backproject(_cam(48, 64), d)
    tpre.bilateral_filter_separable(d, radius=tpre.MAX_RADIUS_PASS)
    assert fake_card.calls[-1][1][5] == tpre.MAX_RADIUS_PASS
    tpre.estimate_normals(pts, smoothing_radius=tpre.MAX_BOX_RADIUS)
    assert fake_card.calls[-1][1][10] == tpre.MAX_BOX_RADIUS
    assert _counts() == (before[0] + 4, before[1] + 1, before[2] + 3)
    calls = len(fake_card.calls)
    for bad in ({"radius": -1}, {"radius": tpre.MAX_RADIUS_PASS + 1}):
        with pytest.raises(ValueError):
            tpre.bilateral_filter_separable(d, **bad)
    with pytest.raises(ValueError):
        tpre.estimate_normals(pts, smoothing_radius=tpre.MAX_BOX_RADIUS + 1)
    assert len(fake_card.calls) == calls
    with pytest.raises(ValueError):
        tpre.bilateral_pass(d, 2)
    with pytest.raises(ValueError):
        tpre.estimate_normals(pts, smoothing_radius=-1)


def _same(a, b):
    """Equal bits, NaN where NaN."""
    return (a.shape == b.shape and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num().view(torch.int32), b.nan_to_num().view(torch.int32)))


class _PlainLibrary(_FakeLibrary):
    """A stand-in kernel library whose K3 and K4 entry points run the plain
    versions on the memory they are handed, as the kernels would: a result
    equals the plain version's only if the wrapper passed the image's values
    as a contiguous float32 array and read the output back as one. The
    filters take their default sigmas."""

    def __init__(self, cam):
        super().__init__()
        self.cam = cam

    @staticmethod
    def _read(ptr, shape):
        n = math.prod(shape)
        a = np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))
        return torch.from_numpy(a.reshape(shape).copy())

    @staticmethod
    def _write(ptr, x):
        a = np.ctypeslib.as_array((ctypes.c_float * x.numel()).from_address(ptr))
        a[:] = x.contiguous().reshape(-1).numpy()

    def tsdf_bilateral_2d(self, src, dst, h, w, radius, sw, table, inv2sr, vec, stream):
        self.calls.append(("tsdf_bilateral_2d", (src, dst, h, w, radius, sw, table, inv2sr,
                                                 vec)))
        k = 2 * radius + 1
        assert torch.equal(self._read(table, (k, k)),
                           tpre._spatial_weights(radius, 3.0, torch.device("cpu")))
        self._write(dst, tpre.bilateral_filter_reference(self._read(src, (h, w)), radius))
        return 0

    def tsdf_bilateral_pass(self, src, dst, h, w, mode, radius, sw, inv2sr, vec, stream):
        self.calls.append(("tsdf_bilateral_pass", (src, dst, h, w, mode, radius, sw, inv2sr,
                                                   vec)))
        img = self._read(src, (h, w))
        out = (tpre.bilateral_filter_separable_reference(img, radius)
               if mode == tpre._PASS_SEPARABLE
               else tpre.bilateral_pass_reference(img, mode, radius))
        self._write(dst, out)
        return 0

    def tsdf_normals(self, depth, points, normals, h, w, inv_fx, inv_fy, cx, cy, factor,
                     radius, vec, stream):
        self.calls.append(("tsdf_normals", (depth, points, normals, h, w, radius, vec)))
        if depth is not None:
            self._write(points, tcam.backproject(self.cam, self._read(depth, (h, w))))
        pts = self._read(points, (h, w, 3))
        self._write(normals, tpre.estimate_normals_reference(pts, factor, radius))
        return 0


@pytest.fixture
def plain_card(monkeypatch):
    """_PlainLibrary for 37x53 images, and CPU tensors taken as card tensors."""
    lib = _PlainLibrary(_cam(37, 53))
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(tpre, "_on_card", lambda x, what: True)
    return lib


# the depth images a card path may be handed, all with the values of one
# float32 image: a crop of a larger image, a transposed layout, float64
P4_VIEWS = {
    "crop": lambda d: torch.nn.functional.pad(d, (3, 2, 1, 4), value=7.0)[1:-4, 3:-2],
    "transpose": lambda d: d.t().contiguous().t(),
    "float64": lambda d: d.double(),
}


@pytest.mark.parametrize("view", list(P4_VIEWS))
def test_card_wrappers_take_any_layout_as_its_float32_copy(view, plain_card):
    """A cropped, a transposed and a float64 depth reach K3 and K4 as a
    contiguous float32 copy: each wrapper's result equals the plain version
    on the contiguous float32 image, bit for bit, and each launch is
    counted."""
    d = torch.from_numpy(_depth(37, 53, seed=3))
    x = P4_VIEWS[view](d)
    assert not (x.is_contiguous() and x.dtype == torch.float32)
    assert torch.equal(x.float().nan_to_num(), d.nan_to_num())
    cam = plain_card.cam

    def frame(filt):
        p = tcam.backproject(cam, filt(d) if filt else d)
        return p, tpre.estimate_normals_reference(p)

    cases = [(lambda v: tpre.bilateral_filter(v), lambda: tpre.bilateral_filter_reference(d),
              (0, 1, 0)),
             (lambda v: tpre.bilateral_filter_separable(v),
              lambda: tpre.bilateral_filter_separable_reference(d), (1, 0, 0)),
             (lambda v: tpre.bilateral_pass(v, 1), lambda: tpre.bilateral_pass_reference(d, 1),
              (1, 0, 0)),
             (lambda v: tpre.preprocess_frame(v, cam=cam),
              lambda: frame(tpre.bilateral_filter_reference), (0, 1, 1)),
             (lambda v: tpre.preprocess_frame(v, cam=cam, bilateral_mode="separable"),
              lambda: frame(tpre.bilateral_filter_separable_reference), (1, 0, 1)),
             (lambda v: tpre.preprocess_frame(v, cam=cam, bilateral=False),
              lambda: frame(None), (0, 0, 1))]
    for call, want, launches in cases:
        before = _counts()
        got = call(x)
        assert tuple(a - b for a, b in zip(_counts(), before)) == launches
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want() if isinstance(got, tuple) else (want(),)):
            assert a.dtype == torch.float32 and _same(a, b)
    pts = tcam.backproject(cam, d)
    given = {"crop": lambda p: torch.nn.functional.pad(p, (0, 0, 2, 1, 1, 2))[1:-2, 2:-1],
             "transpose": lambda p: p.transpose(0, 1).contiguous().transpose(0, 1),
             "float64": lambda p: p.double()}[view](pts)
    assert _same(tpre.estimate_normals(given), tpre.estimate_normals_reference(pts))


def test_card_radii_up_to_the_kernels_limits_launch(plain_card):
    """Radius 17 (past every kernel's limit before the limits were set by
    shared memory) launches the 2-D form, the separable filter, one pass
    and K4 from points, each counted and equal to the plain version; one
    past each kernel's largest radius, a negative radius, a wrong rank and
    a bad axis raise and launch nothing."""
    d = torch.from_numpy(_depth(37, 53, seed=4))
    x = P4_VIEWS["transpose"](d)
    pts = tcam.backproject(plain_card.cam, d)
    cases = [(tpre.bilateral_filter, tpre.bilateral_filter_reference, tpre.MAX_RADIUS_2D,
              (0, 1, 0)),
             (tpre.bilateral_filter_separable, tpre.bilateral_filter_separable_reference,
              tpre.MAX_RADIUS_PASS, (1, 0, 0)),
             (lambda v, radius: tpre.bilateral_pass(v, 0, radius),
              lambda v, radius: tpre.bilateral_pass_reference(v, 0, radius),
              tpre.MAX_RADIUS_PASS, (1, 0, 0))]
    for fn, ref, limit, launches in cases:
        before = _counts()
        assert _same(fn(x, radius=17), ref(d, radius=17))
        assert tuple(a - b for a, b in zip(_counts(), before)) == launches
        calls = len(plain_card.calls)
        for bad in (limit + 1, -1):
            with pytest.raises(ValueError):
                fn(x, radius=bad)
        assert len(plain_card.calls) == calls
    before = _counts()
    given = pts.transpose(0, 1).contiguous().transpose(0, 1)
    assert _same(tpre.estimate_normals(given, smoothing_radius=17),
                 tpre.estimate_normals_reference(pts, tpre.DEPTH_CHANGE_FACTOR, 17))
    assert _counts()[2] == before[2] + 1
    for bad in (tpre.MAX_BOX_RADIUS + 1, -1):
        with pytest.raises(ValueError):
            tpre.estimate_normals(pts, smoothing_radius=bad)
    for fn in (tpre.bilateral_filter, tpre.bilateral_filter_separable):
        with pytest.raises(ValueError):
            fn(d[None])
    with pytest.raises(ValueError):
        tpre.bilateral_pass(x, 2)
    with pytest.raises(ValueError):
        tpre.preprocess_frame(d[None], cam=plain_card.cam, bilateral=False)
    with pytest.raises(ValueError):
        tpre.estimate_normals(d)


@pytest.mark.parametrize("mode", ["full", "separable"])
def test_process_frame_takes_cropped_and_transposed_depth(mode, monkeypatch):
    """Reconstruction.process_frame with K3 and K4 taken through the plain
    stand-in library: a cropped, a transposed and a float64 depth give the
    contiguous float32 depth's poses and grid bit for bit (the full 2-D
    filter with dense fusion, and the separable filter with brick-major
    rows at 48^3)."""
    import dataclasses

    from tracking_sdf_tpu_torch.config import GridParams, PipelineConfig, preset
    from tracking_sdf_tpu_torch.data.synthetic import SphereScene, look_at, render_scene_depth
    from tracking_sdf_tpu_torch.grid.grid import FIELDS
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    cam = tcam.PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
    lib = _PlainLibrary(cam)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(tpre, "_on_card", lambda x, what: True)
    grid = GridParams(m=48, width=2.0, height=2.0, depth=2.0, origin=(-1.0, -1.0, -1.0),
                      delta=0.15, epsilon=0.02)
    if mode == "full":
        cfg = PipelineConfig(grid=grid, trajectory_path=None)
    else:
        base = preset("tum256")
        cfg = dataclasses.replace(base, grid=grid, trajectory_path=None,
                                  fusion=base.fusion._replace(brick_cap=864, brick_cap_free=216))
    assert cfg.bilateral_filter and cfg.bilateral_mode == mode
    eyes = [(0.0, -1.5, 0.2), (0.02, -1.5, 0.21)]
    depths = [render_scene_depth(SphereScene(center=(0.15, 0.1, 0.0), radius=0.4), cam,
                                 look_at(e, (0, 0, 0), device="cpu")) for e in eyes]
    runs = {}
    for view in ("contiguous", *P4_VIEWS):
        r = Reconstruction(cam, cfg, device="cpu",
                           initial_pose=look_at(eyes[0], (0, 0, 0), device="cpu"))
        before = _counts()
        for i, d in enumerate(depths):
            r.process_frame(d if view == "contiguous" else P4_VIEWS[view](d), timestamp=i)
        k3 = 1 if mode == "separable" else 0
        assert tuple(a - b for a, b in zip(_counts(), before)) == (2 * k3, 2 * (1 - k3), 2)
        runs[view] = r
    want = runs.pop("contiguous")
    assert want.stats[-1].gn_iterations > 0 and int((want.grid.W > 0).sum()) > 1000
    for view, r in runs.items():
        assert torch.equal(r.pose.R, want.pose.R) and torch.equal(r.pose.t, want.pose.t), view
        for k in FIELDS:
            assert _same(getattr(r.grid, k), getattr(want.grid, k)), (view, k)
