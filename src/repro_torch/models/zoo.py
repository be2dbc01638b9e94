"""Model facade and the serving plane's packing (the counterpart of
``repro.models.zoo``, dense serving path)."""

from __future__ import annotations

from typing import Optional

from ..core.policy import PrecisionPolicy
from ..kernels.ops import pack_tensor
from . import attention as A
from . import transformer as T

__all__ = ["init_model", "apply_model", "decode_model", "init_cache",
           "pack_params", "quantize_cache"]

init_model = T.lm_init
apply_model = T.lm_apply
decode_model = T.lm_decode
init_cache = T.init_cache


def pack_params(params, policy: PrecisionPolicy):
    """Replace weight-matrix leaves (``.../w``) with PackedTensors per the
    policy; stacked (L, K, N) weights pack per slice along the last axis
    (the reference's N-D layout).  Biases, norms and the embedding stay
    dense."""

    def rec(node, path=""):
        if isinstance(node, dict):
            return {k: rec(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if not path.endswith("/w") or node.dim() < 2:
            return node
        spec = policy.format_for(path)
        if spec.kind == "native":
            return node
        return pack_tensor(spec, node, group_size=policy.group_for(path))

    return rec(params)


def quantize_cache(cache, kv_group: Optional[int] = None):
    """Posit8-quantize a prefill cache: every {k, v} pair becomes
    {k_codes, k_scale, v_codes, v_scale} in the Dh-grouped layout."""
    kc, ks = A.quantize_kv(cache["k"], kv_group)
    vc, vs = A.quantize_kv(cache["v"], kv_group)
    return {"k_codes": kc, "k_scale": ks, "v_codes": vc, "v_scale": vs}
