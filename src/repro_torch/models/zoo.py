"""Model facade and the serving plane's packing (the counterpart of
``repro.models.zoo``, serving path)."""

from __future__ import annotations

from typing import Optional

from ..core.policy import PrecisionPolicy
from ..kernels.ops import pack_tensor
from . import attention as A
from . import ssm as S
from . import transformer as T

__all__ = ["init_model", "apply_model", "decode_model", "init_cache",
           "init_state_cache", "pack_params", "quantize_cache"]

init_model = T.lm_init
apply_model = T.lm_apply
decode_model = T.lm_decode
init_cache = T.init_cache
init_state_cache = T.init_state_cache

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


def quantize_cache(cache, kv_group: Optional[int] = None,
                   quantize_state: bool = False):
    """Posit8-quantize a prefill cache: every attention {k, v} pair
    (stacked, or a hybrid group's sub-dict) becomes {k_codes, k_scale,
    v_codes, v_scale} in the Dh-grouped layout.  Recurrent states pass
    through unchanged, or, with ``quantize_state``, quantize too
    (``ssm.quantize_state``: the slab layout, which decode round-trips
    through posit8 every step)."""
    if "k" in cache and "v" in cache and not isinstance(cache["k"], dict):
        kc, ks = A.quantize_kv(cache["k"], kv_group)
        vc, vs = A.quantize_kv(cache["v"], kv_group)
        return {"k_codes": kc, "k_scale": ks, "v_codes": vc, "v_scale": vs}
    if quantize_state and ("h" in cache or "tm_state" in cache):
        return S.quantize_state(cache, kv_group)
    return {k: quantize_cache(v, kv_group, quantize_state)
            if isinstance(v, dict) else v for k, v in cache.items()}
