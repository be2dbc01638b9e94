"""Decoder blocks and the LM for all four families (the counterpart of
``repro.models.transformer``).

  dense / moe : ``params["layers"]``, every leaf stacked (L, ...);
                attention blocks with an FFN or an MoE.
  ssm (rwkv6) : ``params["layers"]`` stacked (L, ...); RWKV blocks
                (time mix + channel mix).
  hybrid      : ``params["groups"]`` stacked (n_layers / attn_every, ...);
  (jamba)       a group holds ``attn_every`` sub-blocks ``b0..``: attention
                at ``attn_every // 2``, Mamba elsewhere, MoE where
                ``i % moe_every == 1``.

The layout is the reference's scan layout, so ``PrecisionPolicy`` globs
and the packed plane see the same tree; the forward walks layers (or
groups) with a Python loop over slices in place of ``lax.scan``.  A paged
cache's page table and positions go to every attention layer as they
are.  Decode updates the cache in place: attention writes its token's
KV, and recurrent layers copy their new (possibly posit8) state into the
stacked leaves.

The modality frontends are the reference's stubs: an audio config
(musicgen) takes precomputed ``frame_embeds`` in place of tokens, has no
``embed`` and decodes a code through the transposed ``lm_head``; a
vision config (qwen2-vl) splices ``patch_embeds`` over its first tokens
and rotates with M-RoPE over (t, h, w) position streams.

``lm_apply(mode="train")`` is the differentiable forward of ``lm_loss``
(every family): it builds no cache, fake-quantizes one layer's (one
hybrid group's) weights at a time under a QAT policy, and recomputes
each layer in the backward per ``cfg.remat``; the Mamba and RWKV scans
inside it checkpoint each ``cfg.ssm_chunk`` chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .. import resolve_device
from ..core.formats import torch_dtype
from ..core.qat import quantize_tree
from ..kernels.ops import PackedTensor, dequant
from ..kernels.ref import kv_scale_cols
from ..obs import host_span
from ..parallel.sharding import batch_sum, gather
from . import attention as A
from . import layers as L
from . import moe as M
from . import ssm as S

__all__ = ["lm_init", "lm_apply", "lm_decode", "init_cache",
           "init_state_cache", "lm_loss"]

_FAMILY_MIXER = {"dense": "attn", "moe": "attn", "ssm": "rwkv",
                 "hybrid": "group"}
_FRONTENDS = ("none", "audio", "vision")
_ROPE_KINDS = ("default", "mrope")


def _check_family(cfg) -> None:
    if cfg.family not in _FAMILY_MIXER or cfg.frontend not in _FRONTENDS \
            or cfg.rope_kind not in _ROPE_KINDS:
        raise NotImplementedError(
            f"the port serves the families {sorted(_FAMILY_MIXER)} with the "
            f"frontends {_FRONTENDS} and RoPE kinds {_ROPE_KINDS}; "
            f"{cfg.name} is family={cfg.family!r}, frontend="
            f"{cfg.frontend!r}, rope_kind={cfg.rope_kind!r}")


def _family_mixer(cfg) -> str:
    return _FAMILY_MIXER[cfg.family]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _block_init(gen, cfg, mixer: str, use_moe: bool, lead):
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": L.rmsnorm_init(d, lead, gen.device)}
    if mixer == "attn":
        p["attn"] = A.attn_init(gen, cfg, lead)
    elif mixer == "mamba":
        p["mamba"] = S.mamba_init(gen, cfg, lead)
    else:
        p["rwkv"] = S.rwkv_init(gen, cfg, lead)
    p["ln2"] = L.rmsnorm_init(d, lead, gen.device)
    if mixer != "rwkv":  # rwkv carries its own channel mix
        if use_moe:
            p["moe"] = M.moe_init(gen, cfg, lead)
        else:
            p["ffn"] = L.ffn_init(gen, d, cfg.d_ff, cfg.ffn_kind,
                                  cfg.out_bias, lead)
    return p


def _block_apply(p, x, cfg, mixer: str, use_moe: bool, positions,
                 cache=None, pos: int = 0, mode: str = "prefill",
                 pad=None, kv_mask=None):
    """One block.  Returns (x, cache, aux), aux the MoE load-balance loss
    (0.0 without an MoE).  The attention mixer returns
    its prefill kv / chunk kv (None where it wrote in place: decode and
    paged chunk prefill); a recurrent mixer its new state, posit8 again
    when it came in posit8 (re-quantized in the layout it came in).
    Decode and chunk prefill of an attention mixer run as the serving
    sub-block (pre-norm and residual add inside, one ``fwd.*`` span a
    stage); a block's FFN or MoE is one ``fwd.mlp`` span."""
    aux = 0.0
    state_q = None
    if mixer == "attn" and mode == "decode":
        x = A.attn_decode(p["attn"], p["ln1"], x, cfg, cache, pos, pad)
        cache = None
    elif mixer == "attn" and mode == "prefill_chunk":
        x, cache = A.attn_prefill_chunk(p["attn"], p["ln1"], x, cfg,
                                        positions, cache)
    else:
        h = L.rmsnorm(p["ln1"], x)
        if mixer == "attn":
            h, (k, v) = A.attn_apply(p["attn"], h, cfg, positions, kv_mask)
            cache = None if mode == "train" else \
                {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
        elif mixer == "mamba":
            if cache is not None and "h_codes" in cache:
                state_q, cache = cache, S.dequantize_state(cache)
            if mode == "decode":
                h, cache = S.mamba_decode(p["mamba"], h, cfg, cache)
            else:
                h, cache = S.mamba_apply(p["mamba"], h, cfg, cache)
            if state_q is not None:
                cache = S.requantize_state(cache, state_q)
        else:
            if cache is not None and "tm_state_codes" in cache:
                state_q, cache = cache, S.dequantize_state(cache)
            if cache is None:
                cache = S.rwkv_state_init(cfg, x.shape[0], x.device)
            h, cache = S.rwkv_time_mix(p["rwkv"], h, cfg, cache)
        x = x + h
    if mixer == "rwkv":
        h2, cache = S.rwkv_channel_mix(p["rwkv"], L.rmsnorm(p["ln2"], x),
                                       cfg, cache)
        if state_q is not None:
            cache = S.requantize_state(cache, state_q)
        return x + h2, cache, aux
    with host_span("fwd.mlp"):
        h2 = L.rmsnorm(p["ln2"], x)
        if use_moe:
            h2, aux = M.moe_apply(p["moe"], h2, cfg)
        else:
            h2 = L.ffn(p["ffn"], h2, cfg.ffn_kind)
        return x + h2, cache, aux


# ---------------------------------------------------------------------------
# Hybrid (jamba) group
# ---------------------------------------------------------------------------

def _group_layout(cfg):
    """Sub-layer layout inside one jamba group: (mixer, use_moe) each."""
    k = cfg.attn_every
    return [("attn" if i == k // 2 else "mamba",
             cfg.n_experts > 0 and i % cfg.moe_every == 1)
            for i in range(k)]


def attn_key(cfg) -> str:
    """Sub-block key of the attention layer inside a hybrid group."""
    return f"b{cfg.attn_every // 2}"


def _group_apply(p, x, cfg, positions, cache=None, pos: int = 0,
                 mode: str = "prefill", pad=None, kv_mask=None, meta=None):
    """One group.  A paged cache's ``meta`` (page table, positions)
    addresses only the attention sub-block's pool leaves; the Mamba
    sub-blocks carry fixed-size state instead."""
    aux = 0.0
    new_cache = {}
    for i, (mixer, use_moe) in enumerate(_group_layout(cfg)):
        sub = cache.get(f"b{i}") if cache is not None else None
        if meta is not None and mixer == "attn" and sub is not None:
            sub = dict(sub, **meta)
        x, c, a = _block_apply(p[f"b{i}"], x, cfg, mixer, use_moe,
                               positions, sub, pos, mode, pad, kv_mask)
        new_cache[f"b{i}"] = c
        aux = aux + a
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Full LM
# ---------------------------------------------------------------------------

def lm_init(cfg, generator: Optional[torch.Generator] = None, device=None,
            policy=None):
    """Random parameters; ``generator`` (seeded, on the target device)
    decides the device, else a generator seeded 0 on ``device``.  A
    layer stack is drawn one layer at a time.  With a ``policy`` each
    layer (each hybrid sub-block stack) is packed as soon as it is
    drawn, so the f32 tree of a model too big for the card never exists
    whole (the result equals ``zoo.pack_params`` of the f32 tree).  An
    audio config has no ``embed`` and always an ``lm_head``."""
    _check_family(cfg)
    if generator is None:
        generator = torch.Generator(resolve_device(device)).manual_seed(0)
    dev = generator.device
    d = cfg.d_model

    def packed(node, path):
        if policy is None:
            return node
        from .zoo import pack_params
        return pack_params(node, policy, prefix=path)

    p: Dict[str, Any] = {}
    if cfg.frontend != "audio":
        p["embed"] = L.embed_init(generator, cfg.vocab, d)
    mixer = _family_mixer(cfg)
    if mixer == "group":
        n = cfg.n_layers // cfg.attn_every
        p["groups"] = {
            f"b{i}": packed(_block_init(generator, cfg, m, use_moe, (n,)),
                            f"groups/b{i}")
            for i, (m, use_moe) in enumerate(_group_layout(cfg))}
    else:
        p["layers"] = _concat([
            packed(_block_init(generator, cfg, mixer, cfg.family == "moe",
                               (1,)), "layers")
            for _ in range(cfg.n_layers)])
    p["final_norm"] = L.rmsnorm_init(d, device=dev)
    if not cfg.tie_embeddings or cfg.frontend == "audio":
        p["lm_head"] = packed(L.dense_init(generator, d, cfg.vocab),
                              "lm_head")
    return p


def _concat(trees):
    """Per-layer trees with a leading axis of 1 -> one stacked tree (a
    packed leaf's words, scales and mask concatenated alike: a stacked
    pack is per slice, so this equals packing the whole stack)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _concat([t[k] for t in trees]) for k in t0}
    if isinstance(t0, PackedTensor):
        return dataclasses.replace(
            t0, **{f: torch.cat([getattr(t, f) for t in trees])
                   for f in ("words", "scales", "mask")})
    return torch.cat(trees)


def _inputs_to_embeds(p, batch, cfg, dtype):
    """(x, positions) from the batch through the modality frontend (the
    reference's stub: precomputed frame / patch embeddings arrive in the
    batch).  Positions are None where the arange applies."""
    if cfg.frontend == "audio":
        return batch["frame_embeds"].to(dtype), None
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = L.embed(p["embed"], tokens, dtype)
    if cfg.frontend == "vision":
        pe = batch["patch_embeds"].to(dtype)
        n_p = pe.shape[1]
        x = torch.cat([pe, x[:, n_p:]], dim=1)
        return x, _mrope_positions(cfg, b, s, n_p, x.device)
    # ragged left-padded serving batches override the arange: position 0
    # sits at each request's first real token
    return x, batch.get("positions")


def _mrope_positions(cfg, b: int, s: int, n_patches: int, device=None):
    """(3, B, S) int32: patches get (t=0, h, w) grid ids; text continues
    1-D from ``idx - n_patches + 1`` on all three streams."""
    side = max(int(n_patches ** 0.5), 1)
    idx = torch.arange(s, dtype=torch.int32, device=device)
    is_patch = idx < n_patches
    text = idx - n_patches + 1
    t = torch.where(is_patch, 0, text)
    h = torch.where(is_patch, idx // side, text)
    w = torch.where(is_patch, idx % side, text)
    return torch.stack([t, h, w])[:, None, :].expand(3, b, s)


def _layer(tree, i: int):
    """Slice ``i`` of every stacked leaf (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _n_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0] if not isinstance(tree, PackedTensor) \
        else tree.words.shape[0]


def _stack(trees):
    """A list of per-layer trees -> one tree of stacked leaves."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _write_layer(dst, i: int, src) -> None:
    """Copy a layer's new state ``src`` into slice ``i`` of the stacked
    leaves of ``dst``, in place (``src`` leaves missing from ``dst`` --
    the attention sub-block's None -- are skipped)."""
    for k, v in src.items():
        if isinstance(v, dict):
            _write_layer(dst[k], i, v)
        elif v is not None:
            dst[k][i].copy_(v)


def _readout(p, x):
    x = L.rmsnorm(p["final_norm"], x)
    if "lm_head" in p:
        return L.dense(p["lm_head"], x)
    return L.embed_logits(p["embed"], x)


def _pop_paged_meta(cache):
    """Split a paged cache into (pool leaves, meta).  The paged serving
    cache carries ONE ``page_table`` (B, NP) (and, for decode,
    ``positions`` (B,)) at the top level, beside the L-stacked pool
    leaves; it has no layer axis, so the layer loop hands the same
    tensors to every attention layer instead of slicing them."""
    if not (isinstance(cache, dict) and "page_table" in cache):
        return cache, None
    meta = {k: cache[k] for k in ("page_table", "positions") if k in cache}
    return {k: v for k, v in cache.items() if k not in meta}, meta


def _layers_of(p, cfg):
    """(stacked parameter tree, per-slice apply) for the family."""
    mixer = _family_mixer(cfg)
    if mixer == "group":
        return p["groups"], _group_apply

    def block(lp, x, cfg, positions, cache=None, pos=0, mode="prefill",
              pad=None, kv_mask=None, meta=None):
        if meta is not None:
            cache = dict(cache, **meta)
        return _block_apply(lp, x, cfg, mixer, cfg.family == "moe",
                            positions, cache, pos, mode, pad, kv_mask)
    return p["layers"], block


def lm_apply(p, batch, cfg, last_only: bool = False, mode: str = "prefill",
             cache=None, with_aux: bool = False, policy=None):
    """Full-sequence forward.  Returns (logits, cache), or (logits, cache,
    aux) with ``with_aux`` (the MoE load-balance loss summed over layers).

    ``mode="train"``: the differentiable forward of :func:`lm_loss`; it
    builds no cache (``cache`` comes back None).  With a ``policy`` (QAT)
    ``embed`` / ``lm_head`` / ``final_norm`` are fake-quantized first and
    each layer's weights inside the layer loop, so one layer's quantized
    copy is live at a time; ``cfg.remat`` recomputes each layer in the
    backward (``"full"``), all but its 2-D matmul outputs (``"dots"``), or
    nothing (``"none"``).
    ``mode="prefill"``: from an empty cache; attention layers return their
    kv ``{"k", "v"}`` (bf16, stacked (L, B, S, Kh, Dh)) and recurrent
    layers their final f32 state.  ``mode="prefill_chunk"``: one chunk at
    ``batch["positions"]`` continues from ``cache`` -- the family's
    ``init_cache`` tree, whose attention leaves are a bf16 carry (the
    chunk's own kv is returned) or a paged pool with its ``page_table``
    (written in place and returned), and whose recurrent leaves are the
    f32 state carried from the previous chunk (the new state is
    returned).  ``last_only`` reads out the final position only.
    ``batch``: ``tokens`` (B, S), optional ``positions`` (B, S) and
    ``kv_mask`` (B, S) bool for left-padded ragged batches; an audio
    config takes ``frame_embeds`` (B, S, D) in place of tokens, a vision
    config also ``patch_embeds`` (B, P, D) over its first P tokens."""
    _check_family(cfg)
    if mode == "train":
        logits, aux = _train_forward(p, batch, cfg, policy)
        return (logits, None, aux) if with_aux else (logits, None)
    if mode not in ("prefill", "prefill_chunk"):
        raise ValueError(f"lm_apply mode {mode!r}: train, prefill or "
                         f"prefill_chunk")
    if policy is not None:
        raise ValueError("a QAT policy applies to mode='train' only; "
                         "serving packs the weights (zoo.pack_params)")
    with host_span("fwd.embed"):
        x, positions = _inputs_to_embeds(p, batch, cfg,
                                         torch_dtype(cfg.dtype))
    kv_mask = batch.get("kv_mask")
    cache, meta = _pop_paged_meta(cache)
    layers, apply = _layers_of(p, cfg)
    aux = 0.0
    new = []
    for i in range(_n_layers(layers)):
        lc = _layer(cache, i) if cache is not None else None
        x, c, a = apply(_layer(layers, i), x, cfg, positions, lc, mode=mode,
                        kv_mask=kv_mask, meta=meta)
        new.append(c)
        aux = aux + a
    if last_only:
        x = x[:, -1:]
    if meta is not None:
        out_cache = dict(cache, **meta)       # the pool, written in place
    else:
        out_cache = _stack(new)
    with host_span("fwd.readout"):
        logits = _readout(p, x)
    if not with_aux:
        return logits, out_cache
    return logits, out_cache, torch.as_tensor(aux, dtype=torch.float32,
                                              device=x.device)


# 2-D products (a dense weight times activations): what ``remat="dots"``
# keeps, the counterpart of ``checkpoint_dots_with_no_batch_dims``
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _remat(fn, cfg):
    """``fn`` under ``cfg.remat``: ``"none"`` as it is; ``"full"`` its
    activations recomputed in the backward; ``"dots"`` the same but the
    outputs of its 2-D matmuls kept."""
    if cfg.remat == "none":
        return fn
    from torch.utils import checkpoint as C
    if cfg.remat == "dots":
        def ctx():
            return C.create_selective_checkpoint_contexts(list(_DOT_OPS))
        return lambda *a: C.checkpoint(fn, *a, use_reentrant=False,
                                       context_fn=ctx)
    if cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r}: none, full or dots")
    return lambda *a: C.checkpoint(fn, *a, use_reentrant=False)


def _unstack(tree, n: int):
    """A stacked tree -> ``n`` per-layer trees, each leaf cut once with
    ``unbind`` (its backward stacks the layers' grads in one copy)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return tree.unbind(0)


def _train_forward(p, batch, cfg, policy):
    """(logits (B, S, V), aux) of the differentiable forward: one layer
    (a hybrid group) at a time, each under ``_remat``; recurrent layers
    start from a zero state.  Sharded (DTensor) weights are gathered
    whole one layer at a time (``sharding.gather``), again in the
    recompute."""
    mixer = _family_mixer(cfg)
    key = "groups" if mixer == "group" else "layers"
    p = {k: v if k == key else gather(v) for k, v in p.items()}
    if policy is not None:
        for k in ("embed", "lm_head", "final_norm"):
            if k in p:
                p[k] = quantize_tree(p[k], policy, k)
    x, positions = _inputs_to_embeds(p, batch, cfg, torch_dtype(cfg.dtype))
    kv_mask = batch.get("kv_mask")

    def layer(lp, x):
        lp = quantize_tree(gather(lp), policy, key)
        if mixer == "group":
            x, _, a = _group_apply(lp, x, cfg, positions, mode="train",
                                   kv_mask=kv_mask)
        else:
            x, _, a = _block_apply(lp, x, cfg, mixer, cfg.family == "moe",
                                   positions, mode="train", kv_mask=kv_mask)
        return x, torch.as_tensor(a, dtype=torch.float32, device=x.device)

    layer = _remat(layer, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _unstack(p[key], _n_layers(p[key])):
        x, a = layer(lp, x)
        aux = aux + a
    return _readout(p, x), aux


def lm_decode(p, tokens, cfg, cache, pos: int, pad=None):
    """One decode step: tokens (B, 1) -> logits (B, 1, V).  ``cache`` is
    updated in place (slot ``pos`` of every attention layer, the whole
    state of every recurrent one) and returned.  A PAGED cache (pool
    leaves plus a top-level ``page_table`` and ``positions``) decodes
    each request at its own position; ``pos`` is then ignored.  An audio
    config embeds its code through the transposed ``lm_head`` (a packed
    head decoded whole by ``ops.dequant``, the kernel on the card)."""
    _check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    with host_span("fwd.embed"):
        if cfg.frontend == "audio":
            w = p["lm_head"]["w"]
            w = dequant(w, dtype) if isinstance(w, PackedTensor) \
                else w.to(dtype)
            x = w.T[tokens[..., 0]][:, None]
        else:
            x = L.embed(p["embed"], tokens, dtype)
    layers_cache, meta = _pop_paged_meta(cache)
    layers, apply = _layers_of(p, cfg)
    for i in range(_n_layers(layers)):
        lc = _layer(layers_cache, i)
        x, c, _ = apply(_layer(layers, i), x, cfg, None, lc, pos,
                        mode="decode", pad=pad, meta=meta)
        if c is not None:
            _write_layer(layers_cache, i, c)
    with host_span("fwd.readout"):
        return _readout(p, x), cache


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _one_kv(cfg, n: int, batch: int, max_len: int, quantized: bool,
            kv_group: Optional[int], device):
    hd = cfg.resolved_head_dim
    shape = (n, batch, max_len, cfg.n_kv_heads, hd)
    if quantized:
        gs = kv_scale_cols(hd, kv_group)
        sshape = shape[:-1] + (gs,)
        return {"k_codes": torch.zeros(shape, dtype=torch.uint8, device=device),
                "v_codes": torch.zeros(shape, dtype=torch.uint8, device=device),
                "k_scale": torch.ones(sshape, dtype=torch.bfloat16,
                                      device=device),
                "v_scale": torch.ones(sshape, dtype=torch.bfloat16,
                                      device=device)}
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def _stacked(tree, n: int):
    """A per-request state tree with a leading axis of ``n`` layers."""
    if isinstance(tree, dict):
        return {k: _stacked(v, n) for k, v in tree.items()}
    return tree.expand(n, *tree.shape).contiguous()


def init_cache(cfg, batch: int, max_len: int, quantized_kv: bool = False,
               kv_group: Optional[int] = None, device=None):
    """Empty stacked cache of the family's layout: attention layers get
    bf16 k/v (L, B, T, Kh, Dh), or posit8 codes with bf16 scales
    initialised to 1.0; recurrent layers get their zero f32 state."""
    _check_family(cfg)
    device = resolve_device(device)
    mixer = _family_mixer(cfg)
    if mixer == "rwkv":
        return init_state_cache(cfg, batch, device)
    if mixer == "group":
        n = cfg.n_layers // cfg.attn_every
        out = init_state_cache(cfg, batch, device)
        out[attn_key(cfg)] = _one_kv(cfg, n, batch, max_len, quantized_kv,
                                     kv_group, device)
        return dict(sorted(out.items()))
    return _one_kv(cfg, cfg.n_layers, batch, max_len, quantized_kv, kv_group,
                   device)


def init_state_cache(cfg, batch: int, device=None):
    """The recurrent-state-only part of :func:`init_cache`: the rwkv
    per-layer state stack, or the Mamba sub-block states of a hybrid
    group (the attention sub-block pages through the KV pool instead).
    None for pure-attention families."""
    device = resolve_device(device)
    mixer = _family_mixer(cfg)
    if mixer == "rwkv":
        return _stacked(S.rwkv_state_init(cfg, batch, device), cfg.n_layers)
    if mixer == "group":
        n = cfg.n_layers // cfg.attn_every
        return {f"b{i}": _stacked(S.mamba_state_init(cfg, batch, device), n)
                for i, (m, _) in enumerate(_group_layout(cfg))
                if m != "attn"}
    return None


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def lm_loss(p, batch, cfg, aux_weight: float = 0.01, policy=None):
    """Next-token cross-entropy over the labels >= 0 (log-softmax in f32)
    plus ``aux_weight`` times the MoE load-balance loss.  Returns
    ``(loss, (ce, aux))``, differentiable in ``p``.  Inside a mesh
    (``sharding.use_mesh``) the batch holds this rank's rows and both
    terms are the whole batch's."""
    logits, _, aux = lm_apply(p, batch, cfg, mode="train", with_aux=True,
                              policy=policy)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = -batch_sum(torch.sum(ll * mask)) / torch.clamp(
        batch_sum(torch.sum(mask)), min=1.0)
    return ce + aux_weight * aux, (ce, aux)
