"""Per-layer precision policy (the counterpart of ``repro.core.policy``).

An ordered list of (glob over slash-joined parameter paths -> format
name) with a default.  The port's parameter trees are nested dicts with
the reference's keys, so the same globs resolve the same formats.
``model_bytes`` / ``average_bits`` are the reference's memory model.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import formats as fmt
from .formats import FormatSpec

__all__ = ["PrecisionPolicy", "flatten_with_paths", "tree_from_paths"]


# The tree walks below are module-level functions, not nested closures: a
# nested recursive function is a reference cycle (it holds its own cell),
# which would keep the tensors it captured alive until the cyclic garbage
# collector runs -- a train step's whole gradient tree, for one.

def _flatten_into(node, path: str, keep_packed: bool, leaves: list) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _flatten_into(node[k], f"{path}/{k}" if path else str(k),
                          keep_packed, leaves)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten_into(v, f"{path}/{i}" if path else str(i), keep_packed,
                          leaves)
    elif node is None:
        return
    elif hasattr(node, "words") and hasattr(node, "scales"):
        if keep_packed:
            leaves.append((path, node))
        else:
            _flatten_into({"words": node.words, "scales": node.scales,
                           "mask": node.mask}, path, keep_packed, leaves)
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        _flatten_into({f.name: getattr(node, f.name)
                       for f in dataclasses.fields(node)}, path, keep_packed,
                      leaves)
    else:
        leaves.append((path, node))


def flatten_with_paths(tree, keep_packed: bool = False
                       ) -> List[Tuple[str, object]]:
    """Flatten a nested dict/list tree to (slash-path, leaf), dict keys
    sorted.  A packed tensor flattens into its words/scales/mask
    sub-leaves, unless ``keep_packed`` (then it is one leaf); any other
    dataclass (a ``TrainState``) flattens as the dict of its fields."""
    leaves: list = []
    _flatten_into(tree, "", keep_packed, leaves)
    return leaves


def _from_paths(node, path: str, leaves):
    if isinstance(node, dict):
        return {k: _from_paths(v, f"{path}/{k}" if path else str(k), leaves)
                for k, v in node.items()}
    return None if node is None else leaves[path]


def tree_from_paths(template, leaves):
    """A nested dict of ``template``'s structure whose leaf at each
    ``flatten_with_paths`` path is ``leaves[path]`` (None stays None)."""
    return _from_paths(template, "", leaves)


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

    # -- memory model ------------------------------------------------------

    def model_bytes(self, params) -> int:
        """Packed model size under this policy (the paper's 13.5 -> 2.42
        MB): packed codes rounded up to whole bytes, plus an f32 scale
        per (K-group, out-channel) of every slice of a matrix leaf, or one
        per-tensor scale for a vector; native formats at their size."""
        total = 0
        for path, leaf in flatten_with_paths(params):
            spec = self.format_for(path)
            shape = tuple(leaf.shape)
            n = int(np.prod(shape)) if shape else 1
            if spec.kind == "native":
                total += n * fmt.torch_dtype(spec.dtype).itemsize
            else:
                total += (n * spec.bits + 7) // 8
                if len(shape) >= 2:
                    g = self.group_for(path)
                    groups = -(-shape[-2] // g) if g else 1
                    total += (n // (shape[-2] * shape[-1])) \
                        * groups * shape[-1] * 4
                else:
                    total += 4
        return total

    def average_bits(self, params) -> float:
        """Bits per parameter under this policy, weighted by leaf size."""
        bits = 0
        n_tot = 0
        for path, leaf in flatten_with_paths(params):
            spec = self.format_for(path)
            shape = tuple(leaf.shape)
            n = int(np.prod(shape)) if shape else 1
            b = spec.bits if spec.kind != "native" else \
                fmt.torch_dtype(spec.dtype).itemsize * 8
            bits += n * b
            n_tot += n
        return bits / max(n_tot, 1)

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
