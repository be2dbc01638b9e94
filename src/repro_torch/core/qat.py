"""QAT tree transform: fake-quantize parameter subtrees per policy (the
counterpart of ``repro.core.qat``)."""

from __future__ import annotations

from typing import Optional

from . import quant
from .policy import PrecisionPolicy

__all__ = ["quantize_tree"]


def quantize_tree(tree, policy: Optional[PrecisionPolicy], prefix: str = ""):
    """Fake-quantize every matrix leaf (``dim() >= 2``) per ``policy``,
    with the format of ``policy.format_for(path)`` and the scale groups
    of ``policy.group_for(path)``; other leaves pass through.
    ``prefix`` lets a subtree resolve against full-tree patterns."""
    if policy is None:
        return tree
    return _quantize(tree, prefix, policy)


def _quantize(node, path: str, policy: PrecisionPolicy):
    # module-level, not a nested closure: see ``core.policy``'s tree walks
    if isinstance(node, dict):
        return {k: _quantize(v, f"{path}/{k}" if path else k, policy)
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_quantize(v, f"{path}/{i}" if path else str(i),
                                    policy) for i, v in enumerate(node))
    if node is None:
        return None
    if getattr(node, "ndim", 0) < 2:
        return node
    spec = policy.format_for(path)
    if spec.kind == "native":
        return node
    return quant.fake_quant(spec, node, group_size=policy.group_for(path))
