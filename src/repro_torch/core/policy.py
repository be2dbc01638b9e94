"""Per-layer precision policy (the counterpart of ``repro.core.policy``).

An ordered list of (glob over slash-joined parameter paths -> format
name) with a default.  The port's parameter trees are nested dicts with
the reference's keys, so the same globs resolve the same formats.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Dict, List, Optional, Tuple

from . import formats as fmt
from .formats import FormatSpec

__all__ = ["PrecisionPolicy", "flatten_with_paths"]


def flatten_with_paths(tree) -> List[Tuple[str, object]]:
    """Flatten a nested dict/list tree to (slash-path, leaf).  A packed
    tensor flattens into its words/scales/mask sub-leaves."""
    leaves = []

    def rec(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], f"{path}/{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{path}/{i}" if path else str(i))
        elif node is None:
            return
        elif hasattr(node, "words") and hasattr(node, "scales"):
            rec({"words": node.words, "scales": node.scales,
                 "mask": node.mask}, path)
        else:
            leaves.append((path, node))

    rec(tree, "")
    return leaves


@dataclasses.dataclass
class PrecisionPolicy:
    """Ordered pattern rules; first match wins; ``default`` otherwise.
    ``keep_fp32`` patterns always stay fp32.  ``group_size`` is the K-group
    scale granularity of the packed weights and of the KV cache (``None``
    is per-channel)."""

    rules: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    default: str = "fp32"
    keep_fp32: Tuple[str, ...] = (
        "*norm*", "*bias*", "*scale*", "*alpha*", "*embed*", "*rope*",
        "*state*", "*decay*", "*router*", "*d_skip*", "*conv_w*", "*a_log*",
        "*lora*", "*mix_*", "*bonus*", "*dt_proj*",
    )
    group_size: Optional[int] = None

    def format_for(self, path: str) -> FormatSpec:
        for pat in self.keep_fp32:
            if fnmatch.fnmatch(path, pat):
                return fmt.FP32
        for pat, name in self.rules:
            if fnmatch.fnmatch(path, pat):
                return fmt.format_by_name(name)
        return fmt.format_by_name(self.default)

    def group_for(self, path: str) -> Optional[int]:
        """Scale-group size for one parameter (None = per-channel); native
        formats never group."""
        if self.group_size is None:
            return None
        return None if self.format_for(path).kind == "native" \
            else self.group_size

    def resolve(self, params) -> Dict[str, FormatSpec]:
        return {p: self.format_for(p) for p, _ in flatten_with_paths(params)}

    @classmethod
    def uniform(cls, name: str) -> "PrecisionPolicy":
        return cls(rules=[], default=name)

    @classmethod
    def paper_mixed(cls) -> "PrecisionPolicy":
        """The paper's mixed scheme: posit8 for attention and output
        projections, posit16 for a separate head, FP4 elsewhere."""
        return cls(rules=[("*attn*", "posit8_0"), ("*out_proj*", "posit8_0"),
                          ("*head*", "posit16_1")],
                   default="fp4")
