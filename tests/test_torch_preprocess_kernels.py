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
    d = torch.from_numpy(_depth(8, 12))
    x = {"float64": d.double(), "3-D": d[None], "non-contiguous": d.t()}[bad]
    with pytest.raises(ValueError):
        tpre._check_image(x, "depth")
    tpre._check_image(d, "depth")
    tpre._check_image(torch.zeros(8, 12, 3), "points", channels=3)
    with pytest.raises(ValueError):
        tpre._check_image(torch.zeros(12, 8, 3).transpose(0, 1), "points", channels=3)


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
    """The wrappers' copies of csrc/preprocess.cu's radii and tiles, and the
    compiled radii are the defaults the presets run."""
    import inspect

    src = (Path(_build.CSRC) / "preprocess.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kMaxRadius2d"] == tpre.MAX_RADIUS_2D
    assert const["kMaxSepRadius"] == tpre.MAX_RADIUS_PASS
    assert const["kMaxBoxRadius"] == tpre.MAX_BOX_RADIUS
    assert const["kSepRadius"] == tpre.SEP_RADIUS
    assert const["kBoxRadius"] == tpre.SMOOTHING_RADIUS <= tpre.MAX_BOX_RADIUS
    assert (const["kSepH"], const["kSepW"]) == tpre.SEP_TILE
    assert (const["kNormH"], const["kNormW"]) == tpre.NORMALS_TILE
    assert tpre.SEP_TILE[1] % 4 == 0 and tpre.NORMALS_TILE[1] % 4 == 0
    sep = inspect.signature(tpre.bilateral_filter_separable).parameters["radius"].default
    assert sep == tpre.SEP_RADIUS
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
    """K3's separable kernel and K4 (from depth and from points) are asked for
    16-byte loads and stores only where the width is a multiple of 4 and
    every tensor they touch is 16-byte aligned; the arguments follow the C
    signatures and the spatial weights arrive as host floats."""
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
    passes), preprocess_frame one K3 and one K4 launch; bilateral_pass one K3
    launch for its axis."""
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
    for bad in ({"radius": tpre.MAX_RADIUS_PASS + 1}, {"radius": -1}):
        with pytest.raises(ValueError):
            tpre.bilateral_filter_separable(d, **bad)
    with pytest.raises(ValueError):
        tpre.bilateral_pass(d, 2)
    with pytest.raises(ValueError):
        tpre.estimate_normals(tcam.backproject(_cam(48, 64), d),
                              smoothing_radius=tpre.MAX_BOX_RADIUS + 1)
