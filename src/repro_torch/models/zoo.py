"""Model facade and the two precision planes (the counterpart of
``repro.models.zoo``).

  * QAT plane -- ``quantize_params_fake`` fake-quantizes the f32 master
    tree per the ``PrecisionPolicy`` (the forward sees low-bit values,
    gradients flow through the STE); ``loss_fn`` threads the policy into
    the layer loop instead, one layer at a time;
  * serving plane -- ``pack_params`` packs the weight matrices to
    low-bit codes (``PackedTensor`` leaves) that the kernels stream.

With ``policy.group_size`` set both planes grid alike, so a packed
leaf's ``to_dense`` is bitwise ``quantize_params_fake`` of the leaf.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.policy import PrecisionPolicy, flatten_with_paths
from ..core.qat import quantize_tree
from ..kernels.ops import pack_tensor
from ..kernels.ref import quantize_kv
from . import attention as A
from . import ssm as S
from . import transformer as T

__all__ = ["init_model", "apply_model", "decode_model", "init_cache",
           "init_state_cache", "loss_fn", "quantize_params_fake",
           "pack_params", "packed_bytes", "param_count", "quantize_cache"]

init_model = T.lm_init
apply_model = T.lm_apply
decode_model = T.lm_decode
init_cache = T.init_cache
init_state_cache = T.init_state_cache
loss_fn = T.lm_loss

_PACKABLE_SUFFIXES = ("/w", "experts/gate", "experts/up", "experts/down")


def pack_params(params, policy: PrecisionPolicy, prefix: str = ""):
    """Replace weight-matrix leaves (``.../w`` and the stacked expert
    tensors) with PackedTensors per the policy; stacked (L, K, N) or
    (groups, E, K, N) weights pack per slice along the last axis (the
    reference's N-D layout).  Biases, norms, states and the embedding
    stay dense.  ``prefix``: the path of ``params`` in the whole tree
    (packing one block of a model at a time)."""

    def rec(node, path):
        if isinstance(node, dict):
            return {k: rec(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if not any(path.endswith(sfx) for sfx in _PACKABLE_SUFFIXES) \
                or node.dim() < 2:
            return node
        spec = policy.format_for(path)
        if spec.kind == "native":
            return node
        return pack_tensor(spec, node, group_size=policy.group_for(path))

    return rec(params, prefix)


def quantize_params_fake(params, policy: PrecisionPolicy):
    """QAT plane: every matrix leaf fake-quantized per ``policy`` (a
    stacked leaf whole, with its scale groups)."""
    return quantize_tree(params, policy)


def packed_bytes(params, policy: PrecisionPolicy) -> int:
    return policy.model_bytes(params)


def param_count(params) -> int:
    return sum(int(np.prod(tuple(leaf.shape)))
               for _, leaf in flatten_with_paths(params))


def quantize_cache(cache, kv_group: Optional[int] = None,
                   quantize_state: bool = False):
    """Posit8-quantize a prefill cache: every attention {k, v} pair
    (stacked, or a hybrid group's sub-dict) becomes {k_codes, k_scale,
    v_codes, v_scale} in the Dh-grouped layout.  Recurrent states pass
    through unchanged, or, with ``quantize_state``, quantize too
    (``ssm.quantize_state``: the slab layout, which decode round-trips
    through posit8 every step)."""
    if "k" in cache and "v" in cache and not isinstance(cache["k"], dict):
        kc, ks = quantize_kv(cache["k"], kv_group)
        vc, vs = quantize_kv(cache["v"], kv_group)
        return {"k_codes": kc, "k_scale": ks, "v_codes": vc, "v_scale": vs}
    if quantize_state and ("h" in cache or "tm_state" in cache):
        return S.quantize_state(cache, kv_group)
    return {k: quantize_cache(v, kv_group, quantize_state)
            if isinstance(v, dict) else v for k, v in cache.items()}
