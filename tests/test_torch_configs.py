"""The port's config registry against the JAX package's: all ten
architectures, each copy and its ``.reduced()`` equal to the reference's
config field for field, with the same derived properties and analytic
``param_count``; ``ARCH_IDS`` in the reference's order, ``SHAPES``,
``get_shape`` and the ``all_cells()`` grid; the port's ``RunConfig``
copy has the reference's fields and defaults."""

import dataclasses

import pytest

import repro.configs as jax_configs
from repro.configs import get_config as jax_get_config
from repro.configs.base import RunConfig as JaxRunConfig
from repro_torch import configs
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import RunConfig


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference(arch, reduced):
    got, want = get_config(arch), jax_get_config(arch)
    if reduced:
        got, want = got.reduced(), want.reduced()
    assert _fields(got) == _fields(want)
    assert (got.resolved_head_dim, got.n_attn_layers, got.param_count()) == \
        (want.resolved_head_dim, want.n_attn_layers, want.param_count())


def test_registry_order_shapes_and_cells_equal_reference():
    assert configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert len(configs.ARCH_IDS) == 10
    assert list(ARCHS) == list(jax_configs.ARCHS)
    assert {k: _fields(v) for k, v in configs.SHAPES.items()} == \
        {k: _fields(v) for k, v in jax_configs.SHAPES.items()}
    for name in configs.SHAPES:
        assert _fields(configs.get_shape(name)) == \
            _fields(jax_configs.get_shape(name))
    got = [(a, s, _fields(c), _fields(sh), ok)
           for a, s, c, sh, ok in configs.all_cells()]
    want = [(a, s, _fields(c), _fields(sh), ok)
            for a, s, c, sh, ok in jax_configs.all_cells()]
    assert got == want and len(got) == 40


def test_registry_holds_the_served_families():
    assert {get_config(a).family for a in ARCHS} == \
        {"dense", "moe", "ssm", "hybrid"}
    with pytest.raises(KeyError, match="available"):
        get_config("no-such-arch")


def test_run_config_equals_reference():
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(RunConfig)]
    want = [(f.name, f.type, f.default)
            for f in dataclasses.fields(JaxRunConfig)]
    assert got == want
    kw = dict(arch="x", steps=7, microbatch=2, qat=True,
              precision_policy="mixed", grad_compression="posit8",
              opt_state_dtype="posit8", checkpoint_every=3)
    assert _fields(RunConfig(**kw)) == _fields(JaxRunConfig(**kw))
