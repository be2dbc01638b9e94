"""The port's config registry against the JAX package's: every
registered copy, and its ``.reduced()``, equals the reference's config
field for field, with the same derived properties."""

import dataclasses

import pytest

from repro.configs import get_config as jax_get_config
from repro_torch.configs import ARCHS, get_config


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference(arch, reduced):
    got, want = get_config(arch), jax_get_config(arch)
    if reduced:
        got, want = got.reduced(), want.reduced()
    assert _fields(got) == _fields(want)
    assert (got.resolved_head_dim, got.n_attn_layers) == \
        (want.resolved_head_dim, want.n_attn_layers)


def test_registry_holds_the_served_families():
    assert {get_config(a).family for a in ARCHS} == \
        {"dense", "moe", "ssm", "hybrid"}
    with pytest.raises(KeyError, match="available"):
        get_config("no-such-arch")
