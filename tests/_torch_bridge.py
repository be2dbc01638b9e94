"""Test-only JAX -> numpy step of the port's bridge: a JAX parameter or
cache tree becomes nested dicts of numpy arrays, with each PackedTensor
as a dict of its words, scales, mask, shape, spec name and group
(``repro_torch.bridge.params_from_numpy`` takes it from there)."""

import numpy as np

from repro.kernels.ops import PackedTensor


def jax_to_numpy(tree):
    if isinstance(tree, PackedTensor):
        return {"words": np.asarray(tree.words).view(np.int32),
                "scales": np.asarray(tree.scales),
                "mask": np.asarray(tree.mask),
                "shape": tuple(tree.shape), "spec": tree.spec.name,
                "group": tree.group}
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)
