"""The port's config and priors against the JAX package's."""

import dataclasses

import numpy as np
import pytest

from stmask_tpu import config as jcfg
from stmask_tpu.ops.anchors import all_priors as j_all_priors

from stmask_torch import config as tcfg
from stmask_torch.ops.anchors import all_priors as t_all_priors


def _fields(obj, prefix=''):
    """(dotted field name, value) of a config, nested dataclasses flattened."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _fields(v, f'{prefix}{f.name}.')
        else:
            yield f'{prefix}{f.name}', v


def test_registry_names_equal():
    assert sorted(tcfg.REGISTRY) == sorted(jcfg.REGISTRY)
    assert tcfg.MEANS == jcfg.MEANS and tcfg.STD == jcfg.STD


@pytest.mark.parametrize('name', sorted(jcfg.REGISTRY))
def test_preset_equal_field_by_field(name):
    port, ref = tcfg.REGISTRY[name], jcfg.REGISTRY[name]
    assert dict(_fields(port)) == dict(_fields(ref))
    for prop in ('pad_h', 'pad_w', 'num_head_banks', 'num_priors_per_loc',
                 'num_levels', 'num_priors'):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.feature_shapes() == ref.feature_shapes()


@pytest.mark.parametrize('hw', [(360, 640), (96, 128)])
def test_all_priors_bitwise(hw):
    h, w = hw
    port = t_all_priors(tcfg.get_config('STMask_plus_resnet50').replace(
        img_h=h, img_w=w))
    ref = j_all_priors(jcfg.get_config('STMask_plus_resnet50').replace(
        img_h=h, img_w=w))
    assert port.dtype == ref.dtype == np.float32
    assert port.shape == ref.shape
    assert np.array_equal(port, ref)
