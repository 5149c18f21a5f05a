"""Port parity, the configuration: the port's ``Config`` has the JAX
package's fields, defaults and field order, so the two serialize to the same
string and each loads what the other wrote."""
import dataclasses
import json

import pytest

from imfnet_tpu import config as jconfig

from imfnet_tpu_torch import config as pconfig


def _plain(v):
    """Tuples and lists alike (the JAX ``from_json`` leaves some lists)."""
    return [_plain(x) for x in v] if isinstance(v, (list, tuple)) else v


def test_fields_defaults_and_order_are_the_reference_ones():
    jf, pf = dataclasses.fields(jconfig.Config), dataclasses.fields(pconfig.Config)
    assert [f.name for f in pf] == [f.name for f in jf]
    for a, b in zip(jf, pf):
        assert a.default == b.default, a.name


@pytest.mark.parametrize("preset", ["threedmatch_config", "kitti_config"])
def test_default_json_strings_are_equal(preset):
    assert getattr(pconfig, preset)().to_json() == getattr(jconfig, preset)().to_json()


def test_kitti_config_field_by_field():
    j, p = jconfig.kitti_config(), pconfig.kitti_config()
    for f in dataclasses.fields(jconfig.Config):
        assert getattr(p, f.name) == getattr(j, f.name), f.name
    assert p.dataset == "KITTINMPairDataset" and p.grid_extent == (704, 704, 128)
    assert pconfig.kitti_config(voxel_size=0.2).voxel_size == 0.2


OVERRIDES = dict(trainer="TripletLossTrainer", batch_size=3, lr=0.03, iter_size=2,
                 fmr_inlier_ratio_threshes=(0.1, 0.3), grid_extent=(128, 64, 32),
                 grid_extent_buckets=((64, 64, 64), (128, 128, 64)),
                 level_capacity_divisors=(1, 3, 8, 20), resume="some/dir",
                 dataset="SyntheticPairDataset", seed=7, use_grid_maps=False)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_json_written_by_either_package_loads_in_the_other(writer):
    written = (jconfig if writer == "jax" else pconfig).Config(**OVERRIDES)
    s = written.to_json()
    j, p = jconfig.Config.from_json(s), pconfig.Config.from_json(s)
    for f in dataclasses.fields(pconfig.Config):
        assert _plain(getattr(p, f.name)) == _plain(getattr(j, f.name)) \
            == _plain(getattr(written, f.name)), f.name
    # the port restores every tuple, so a round trip is the identity
    assert p == pconfig.Config(**OVERRIDES)
    assert p.to_json() == s


def test_from_json_drops_unknown_keys():
    d = json.loads(pconfig.Config().to_json())
    d["a_field_of_a_later_version"] = 1
    assert pconfig.Config.from_json(json.dumps(d)) == pconfig.Config()
