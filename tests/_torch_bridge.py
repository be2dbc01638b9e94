"""Test-only JAX -> numpy step of the port's bridge: a JAX parameter or
cache tree becomes nested dicts of numpy arrays, with each PackedTensor
as a dict of its words, scales, mask, shape, spec name and group
(``repro_torch.bridge.params_from_numpy`` takes it from there), and the
one-thread fixture the port's test modules share."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port tests' tensors are small: one intra-op thread a worker
    keeps the parallel test run from oversubscribing the cores.  A test
    module takes it with ``from _torch_bridge import one_torch_thread``;
    the setting is restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_to_numpy(tree):
    # the JAX package loads here, not at import: a module that takes only
    # the fixture stays free of jax
    from repro.kernels.ops import PackedTensor

    if isinstance(tree, PackedTensor):
        return {"words": np.asarray(tree.words).view(np.int32),
                "scales": np.asarray(tree.scales),
                "mask": np.asarray(tree.mask),
                "shape": tuple(tree.shape), "spec": tree.spec.name,
                "group": tree.group}
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)
