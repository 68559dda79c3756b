"""The port's configuration against the JAX package's, field for field.

Names, order and values of every field, for the defaults and for every
preset; the port keeps its own copy of the module.
"""
import dataclasses

import pytest

from tracking_sdf_tpu import config as jcfg
from tracking_sdf_tpu_torch import config as tcfg

PRESETS = ["synthetic64", "tum128", "tum256", "tum512"]


def _fields(pc):
    """PipelineConfig -> [(name, value)], NamedTuple fields as their items."""
    out = []
    for f in dataclasses.fields(pc):
        v = getattr(pc, f.name)
        out.append((f.name, list(v._asdict().items()) if hasattr(v, "_asdict") else v))
    return out


@pytest.mark.parametrize("cls", ["GridParams", "TrackingConfig", "FusionConfig",
                                 "RaycastConfig"])
def test_namedtuple_defaults_match_jax(cls):
    ours, theirs = getattr(tcfg, cls)(), getattr(jcfg, cls)()
    assert list(ours._asdict().items()) == list(theirs._asdict().items())


def test_pipeline_defaults_match_jax():
    ours, theirs = tcfg.PipelineConfig(), jcfg.PipelineConfig()
    assert _fields(ours) == _fields(theirs)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    g = tcfg.GridParams(m=64)
    assert (g.extent, g.voxel_size, g.n_voxels) == (
        jcfg.GridParams(m=64).extent, jcfg.GridParams(m=64).voxel_size, 64 ** 3)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_matches_jax(name):
    ours, theirs = tcfg.preset(name), jcfg.preset(name)
    assert _fields(ours) == _fields(theirs)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_unknown_preset_raises():
    with pytest.raises(KeyError):
        tcfg.preset("tum1024")
