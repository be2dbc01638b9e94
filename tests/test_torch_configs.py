"""The port's config registry against the JAX package's: every
registered copy, and its ``.reduced()``, equals the reference's config
field for field, with the same derived properties; the port's
``RunConfig`` copy has the reference's fields and defaults."""

import dataclasses

import pytest

from repro.configs import get_config as jax_get_config
from repro.configs.base import RunConfig as JaxRunConfig
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
    assert (got.resolved_head_dim, got.n_attn_layers) == \
        (want.resolved_head_dim, want.n_attn_layers)


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
