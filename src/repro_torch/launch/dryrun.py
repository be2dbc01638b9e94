"""Dry run of one (arch x shape x mesh) cell on fake tensors: one rank's
FLOPs, bytes, collectives and peak memory with nothing allocated (the
counterpart of ``repro.launch.dryrun``).

Per cell this tool:
  1. builds the step the shape dictates (the train step for train_4k,
     the prefill or chunk-prefill step for prefill_32k, the serve step
     -- or the continuous engine's decode loop over the paged pool -- for
     decode_*) and its arguments (``launch/specs.py``), under
     ``torch._subclasses.fake_tensor.FakeTensorMode``: tensors with
     shapes and dtypes and no data;
  2. lays the arguments out on the mesh as DTensors by
     ``parallel/sharding.py`` (``param_sharding_tree`` /
     ``cache_sharding_tree``), on a fake process group of the mesh's
     size (``torch.testing._internal.distributed.fake_pg``), and runs
     the step for rank 0;
  3. counts, per rank: FLOPs (``torch.utils.flop_counter``'s formulas),
     bytes accessed (each op's input plus output bytes: no fusion, views
     move nothing), the collectives with their operand and result bytes,
     and the peak of the live fake storages;
  4. writes the reference's record (``memory``, ``cost``,
     ``collectives``, ``roofline``, ``params_*``) through
     ``roofline.analysis`` on the H100's constants to
     ``build/dryrun_torch/`` under the naming contract of
     ``artifacts/dryrun/README.md``.

What one rank runs is what the port runs.  Training is the port's
sharded step (weights gathered one layer at a time, this rank's rows of
the batch).  The port serves unsharded, so a serving rank gathers the
weights whole and every cache leaf whole but for its own requests' rows,
runs the step on its rows, and keeps its part of the new cache.  At mesh
1x1 there is no process group: the unsharded step runs as it does on one
card.

The hand kernels count as one op each with their own FLOPs and operand
bytes (``kernels/fake.py``), never through their plain versions.  The
paged kernels read positions that are data, so they count every slot the
page table spans.  torch runs every layer, so there is no layer
extrapolation (``"extrapolation": null``, as the reference's
``--no-extrapolate``).  The fake process group is process-wide: run one
mesh size per process.

  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod]
  ... [--mesh 16x16|2x2|1x1] [--policy mixed|fp4|posit8_0|bf16|fp32]
      [--quantized-kv] [--paged [--pool-frac 0.25]] [--opt-dtype posit8]
      [--chunked-prefill [--prefill-chunk 256]] [--microbatch N]
      [--grad-compression posit8] [--no-qat] [--global-batch B]
      [--seq-len S] [--prompt-len P] [--tag NAME] [--out DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..configs import SHAPES, all_cells, get_config
from ..configs.base import RunConfig
from ..core.policy import PrecisionPolicy, flatten_with_paths
from ..kernels import fake
from ..kernels.ops import PackedTensor
from ..models import zoo
from ..parallel import sharding as sh
from ..roofline import analysis as ra
from ..roofline.hw import H100_SXM
from . import specs as sp

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                       "dryrun_torch")

WEIGHT_BITS = {"fp4": 4.0, "posit8_0": 8.0, "posit16_1": 16.0, "bf16": 16.0,
               "fp32": 32.0}

# c10d and functional-collective op names -> the reference's kinds
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
# ops whose (output, input) tensor arguments come in that order
_OUT_FIRST = ("_allgather_base_", "_reduce_scatter_base_", "alltoall_base_",
              "all_gather_into_tensor_out")
# ops that allocate or relabel without moving data
_NO_TRAFFIC = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "lift_fresh", "lift_fresh_copy", "alias", "wait_tensor",
    "_local_scalar_dense", "device", "set_", "resize_", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size"})
_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "sigmoid",
    "rsqrt", "sqrt", "sin", "cos", "erf", "_softmax", "_log_softmax",
    "silu", "gelu", "pow", "logsumexp"})


def _local(t):
    """This rank's tensor of a DTensor; a plain tensor as it is."""
    return getattr(t, "_local_tensor", t)


def _tensors(tree):
    """The (local) tensors of an op's arguments or results."""
    return [_local(t) for t in tree_leaves(tree) if isinstance(t,
                                                              torch.Tensor)]


def _leaves(tree):
    """The (local) tensors of a step's arguments or results: dicts,
    tuples, PackedTensors and ``TrainState``s walked."""
    return [_local(t) for _, t in flatten_with_paths(tree)
            if isinstance(t, torch.Tensor)]


class StepCounter(TorchDispatchMode):
    """Counts one rank's step op by op: bytes accessed (inputs plus
    outputs, each distinct tensor once), transcendentals, collectives
    and the hand kernels' calls (``kernels.fake``), and tallies the live
    fake storages for the peak."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.collectives = []          # (kind, operand bytes, result bytes)
        self.kernels = {}              # name -> {"calls", "flops", "bytes"}
        self._live = {}                # id(storage) -> bytes
        self.live_bytes = 0
        self.peak_bytes = 0

    # -- memory ------------------------------------------------------------

    def hold(self, tensors) -> None:
        """Tally the storages of ``tensors`` until they are freed."""
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def storages(self, tensors) -> dict:
        return {id(t.untyped_storage()): t.untyped_storage().nbytes()
                for t in tensors}

    # -- ops ---------------------------------------------------------------

    def kernel(self, name: str, flops: float, nbytes: int) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self.hold(outs)
        name = func.__name__.split(".")[0]
        if func.namespace in ("_c10d_functional", "c10d"):
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                ins = _tensors((args, kwargs))
                if name in _OUT_FIRST:
                    res, opd = ins[:1], ins[1:2]
                elif func.namespace == "c10d":
                    res = opd = ins[:1] if name != "allgather_" else ins[1:]
                else:
                    opd, res = ins[:1], outs
                self.collectives.append((kind, fake.nbytes(opd),
                                         fake.nbytes(res)))
            return out
        if func.is_view or name in _NO_TRAFFIC:
            return out
        self.ops += 1
        seen, total = set(), 0
        for t in _tensors((args, kwargs)) + outs:
            if id(t) not in seen:
                seen.add(id(t))
                total += t.numel() * t.element_size()
        self.bytes += total
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        return out


# ---------------------------------------------------------------------------
# arguments on the mesh
# ---------------------------------------------------------------------------

def _map(node, fn, path=""):
    """``node`` with each tensor leaf ``fn(path, leaf)`` (a PackedTensor's
    words, scales and mask at ``path/words`` ...); None stays None."""
    if isinstance(node, dict):
        return {k: _map(v, fn, f"{path}/{k}" if path else k)
                for k, v in node.items()}
    if isinstance(node, PackedTensor):
        return dataclasses.replace(node, **{
            f: fn(f"{path}/{f}", getattr(node, f))
            for f in ("words", "scales", "mask")})
    if node is None:
        return None
    return fn(path, node)


def _shardings(tree) -> dict:
    return dict(flatten_with_paths(tree))


def _placed(tree, shardings):
    return _map(tree, lambda p, t: sh.place(t, shardings[p]))


def _serving(dt, batch: int, keep: bool):
    """A serving rank's view of an argument: gathered whole, or with
    ``keep`` whole but for the request rows its data axes hold."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(dt, DTensor):
        return dt
    names = dt.device_mesh.mesh_dim_names
    pl = [p if keep and isinstance(p, Shard) and a in sh.DATA_AXES
          and dt.shape[p.dim] == batch else Replicate()
          for a, p in zip(names, dt.placements)]
    return dt.redistribute(dt.device_mesh, pl).to_local()


def _cut(t, like):
    """This rank's part of ``t`` (whole along the axes ``_serving``
    gathered) in the layout of the DTensor ``like``: slices, no
    communication."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(like, DTensor) or t.shape == like.to_local().shape:
        return t
    mesh = like.device_mesh
    coord = mesh.get_coordinate()
    for i, p in enumerate(like.placements):
        if isinstance(p, Shard) and t.shape[p.dim] != like.to_local().shape[
                p.dim]:
            t = t.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return t.clone(memory_format=torch.contiguous_format)


def _batch_sharding(mesh, t):
    """The reference's batch layout: dim 0 over the data axes that
    divide it (a batch of 1 stays whole)."""
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    got, prod = [], 1
    for a in sh.DATA_AXES:
        if a in axes and t.shape[0] % (prod * axes[a]) == 0:
            got.append(a)
            prod *= axes[a]
    spec = [None] * t.dim()
    if got and t.dim():
        spec[0] = tuple(got) if len(got) > 1 else got[0]
    return sh.NamedSharding(mesh, tuple(spec))


def _policy(name: str) -> PrecisionPolicy:
    if name == "mixed":
        return PrecisionPolicy.paper_mixed()
    return PrecisionPolicy.uniform(name)


def _serve_params(cfg, policy, policy_name: str, gen):
    if policy_name == "fp32":
        return zoo.init_model(cfg, gen)
    if policy_name == "bf16":
        return _map(zoo.init_model(cfg, gen),
                    lambda p, t: t.to(torch.bfloat16)
                    if t.dtype == torch.float32 else t)
    return zoo.init_model(cfg, gen, policy=policy)


# ---------------------------------------------------------------------------
# the cell
# ---------------------------------------------------------------------------

def _fake_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(
                f"this process's fake group has {dist.get_world_size()} "
                f"ranks; a {world}-rank mesh needs a process of its own")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _make_mesh(mesh_shape):
    from .mesh import make_host_mesh, make_production_mesh
    _fake_group(math.prod(mesh_shape))
    if tuple(mesh_shape) == (16, 16):
        return make_production_mesh(device="cpu")
    if tuple(mesh_shape) == (2, 16, 16):
        return make_production_mesh(multi_pod=True, device="cpu")
    if len(mesh_shape) != 2:
        raise ValueError(f"mesh {mesh_shape}: 2 axes, or 2x16x16")
    return make_host_mesh(*mesh_shape, device="cpu")


def _build(cfg, shape, mesh, policy, policy_name, run_kw, quantized_kv,
           prompt_len):
    """(step, args): ``step(*args)`` runs one rank's step.  ``args`` are
    the step's device arguments (this rank's parts on a mesh)."""
    from ..serve.engine import (ServeEngine, _build_decode_loop,
                                build_prefill_chunk_step, build_prefill_step,
                                build_serve_step)
    from ..train.loop import build_train_step, init_state
    gen = torch.Generator().manual_seed(0)
    b, s = shape.global_batch, shape.seq_len
    group = policy.group_size

    if shape.kind == "train":
        run = RunConfig(qat=run_kw["qat"], precision_policy=policy_name,
                        opt_state_dtype=run_kw["opt_dtype"],
                        microbatch=run_kw["microbatch"],
                        grad_compression=run_kw["grad_compression"])
        state = init_state(cfg, run, gen)
        batch = sp.batch_specs(cfg, b, s, device="cpu")
        if mesh is None:
            return build_train_step(cfg, run, policy), (state, batch)
        step, _ = build_train_step(cfg, run, policy, mesh=mesh)
        from ..train.loop import TrainState

        def placed(tree):
            if tree is None:
                return None
            return _placed(tree, _shardings(sh.param_sharding_tree(mesh,
                                                                   tree)))
        state = TrainState(state.step, placed(state.params),
                           placed(state.opt_state), placed(state.residuals))
        return step, (state, batch)

    params = _serve_params(cfg, policy, policy_name, gen)
    if mesh is not None:
        params = _placed(params, _shardings(sh.param_sharding_tree(mesh,
                                                                   params)))

    def whole(tree):
        return _map(tree, lambda p, t: _serving(t, b, keep=False))

    def rows(tree):
        return _map(tree, lambda p, t: _serving(t, b, keep=True))

    def laid_out(tree, batch_):
        """A cache tree laid out by ``cache_sharding_tree``."""
        if mesh is None:
            return tree
        return _placed(tree, _shardings(sh.cache_sharding_tree(mesh, tree,
                                                               batch_)))

    def by_rows(tree):
        """Inputs with a leading request dim, split over the data axes."""
        if mesh is None:
            return tree
        return _map(tree, lambda p, t: sh.place(t, _batch_sharding(mesh, t)))

    if shape.kind == "prefill" and run_kw["chunked_prefill"]:
        chunk = min(run_kw["prefill_chunk"] or 256, s)
        inp = sp.chunk_prefill_specs(cfg, chunk, s - chunk, device="cpu")
        fn = build_prefill_chunk_step(cfg, kv_group=group)
        ctx = laid_out(inp["ctx"], 1)

        def chunk_step(params, tokens, ctx, start):
            return fn(whole(params), tokens, whole(ctx), start)
        return chunk_step, (params, inp["tokens"], ctx, inp["start"])

    if shape.kind == "prefill":
        batch = by_rows(sp.batch_specs(cfg, b, s, with_labels=False,
                                       device="cpu"))
        fn = build_prefill_step(cfg, last_logit_only=run_kw["last_logit_only"],
                                quantized_kv=quantized_kv, kv_group=group)
        return (lambda params, batch: fn(whole(params), rows(batch)),
                (params, batch))

    # decode
    if prompt_len:
        # ServeEngine.generate's first steps: prefill the prompt, pad the
        # cache to max_len, one decode step
        if mesh is not None:
            raise ValueError("--prompt-len runs the unsharded engine: "
                             "use mesh 1x1")
        eng = ServeEngine.__new__(ServeEngine)
        eng.max_len = s
        prefill = build_prefill_step(cfg, last_logit_only=True,
                                     quantized_kv=quantized_kv,
                                     kv_group=group)
        serve = build_serve_step(cfg)
        if "embed" in params:      # ServeEngine keeps the table in bf16
            params = dict(params, embed={"table": params["embed"][
                "table"].to(torch.bfloat16)})

        def generate(params, tokens):
            logits, cache = prefill(params, {"tokens": tokens})
            cache = eng._pad_cache(cache)
            last = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            return serve(params, last, cache, prompt_len, None, None, 0.0)
        return generate, (params, sp.batch_specs(
            cfg, b, prompt_len, with_labels=False, device="cpu")["tokens"])

    tokens = by_rows(torch.empty((b, 1), dtype=torch.int32))
    if run_kw["paged"]:
        c = sp.paged_cache_specs(cfg, b, s, pool_frac=run_kw["pool_frac"],
                                 kv_group=group, device="cpu")
        cache = laid_out(c, b)
        loop = _build_decode_loop(cfg, 0.0, 1, 0)
        keys = ("page_table", "slab_table", "positions")
        aux = by_rows({"done": torch.zeros((b,), dtype=torch.bool),
                       **{k: torch.empty((b,), dtype=torch.int32)
                          for k in ("budget", "eos", "rids", "gen_idx")}})

        def paged_step(params, tokens, cache, aux):
            pool = {k: v for k, v in cache.items() if k not in keys}
            full = whole(pool)
            r = rows({k: cache[k] for k in keys if k in cache})
            out = loop(whole(params), rows(tokens), r["positions"], full,
                       r.get("page_table"), r.get("slab_table"), **rows(aux))
            return out, _map(full, lambda p, t: _cut(t, _get(pool, p)))
        return paged_step, (params, tokens, cache, aux)

    cache = laid_out(sp.cache_specs(cfg, b, s, quantized_kv, kv_group=group,
                                    device="cpu"), b)
    fn = build_serve_step(cfg)

    def serve_step(params, tokens, cache):
        nxt, new = fn(whole(params), rows(tokens), rows(cache), s - 1, None,
                      None, 0.0)
        return nxt, _map(new, lambda p, t: _cut(t, _get(cache, p)))
    return serve_step, (params, tokens, cache)


def _get(tree, path: str):
    node = tree
    for k in path.split("/"):
        node = getattr(node, k) if isinstance(node, PackedTensor) \
            else node[k]
    return node


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               mesh_shape=None, policy_name: str = "mixed",
               quantized_kv: bool = False, opt_dtype: str = "posit8",
               attn_impl: str = None, remat: str = None, microbatch: int = 0,
               grad_compression: str = "none", qat: bool = True,
               seq_chunk: int = None, verbose: bool = True,
               extrapolate: bool = True, last_logit_only: bool = False,
               attn_scores_f32: bool = True, decode_impl: str = "blocked",
               paged: bool = False, pool_frac: float = 0.25,
               chunked_prefill: bool = False, prefill_chunk: int = 256,
               global_batch: int = None, seq_len: int = None,
               prompt_len: int = 0, reduced: bool = False):
    """One cell's record.  ``mesh_shape`` (default (16, 16), or
    (2, 16, 16) with ``multi_pod``); (1, 1) runs the unsharded step with
    no process group.  ``global_batch`` / ``seq_len`` resize the shape;
    ``prompt_len`` makes a decode cell ``ServeEngine.generate``'s first
    steps (prefill, pad, one decode step; mesh 1x1).  ``reduced`` takes
    the config's CPU-test variant.  ``extrapolate`` is kept for the
    reference's flags: every layer runs, so nothing is extrapolated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    shape = SHAPES[shape_name]
    shape = dataclasses.replace(
        shape, global_batch=global_batch or shape.global_batch,
        seq_len=seq_len or shape.seq_len)
    over = {"attn_impl": attn_impl or "triangular",
            "attn_scores_f32": attn_scores_f32, "decode_impl": decode_impl}
    if remat:
        over["remat"] = remat
    if seq_chunk:
        over["seq_chunk"] = seq_chunk
    elif shape.seq_len > 8192:
        over["seq_chunk"] = shape.seq_len // 8   # the reference's cap
    cfg = dataclasses.replace(cfg, **over)
    mesh_shape = tuple(mesh_shape or ((2, 16, 16) if multi_pod else (16, 16)))
    chips = math.prod(mesh_shape)
    policy = _policy(policy_name)
    run_kw = dict(qat=qat, opt_dtype=opt_dtype, microbatch=microbatch,
                  grad_compression=grad_compression,
                  last_logit_only=last_logit_only, paged=paged,
                  pool_frac=pool_frac, chunked_prefill=chunked_prefill,
                  prefill_chunk=prefill_chunk)

    counter = StepCounter()
    t0 = time.perf_counter()
    mesh = _make_mesh(mesh_shape) if chips > 1 else None
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = _build(cfg, shape, mesh, policy, policy_name, run_kw,
                            quantized_kv, prompt_len)
        arg_ts = _leaves(args)
        arg_st = counter.storages(arg_ts)
        counter.hold(arg_ts)
        del arg_ts
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as flops, \
                fake.recording(counter), counter:
            out = step(*args)
        t_run = time.perf_counter() - t0
        out_st = counter.storages(_leaves(out))
        del out

    arg_bytes = sum(arg_st.values())
    out_bytes = sum(out_st.values())
    alias_bytes = sum(n for k, n in out_st.items() if k in arg_st)
    peak = counter.peak_bytes
    temp = max(peak - arg_bytes - (out_bytes - alias_bytes), 0)
    k_flops = sum(k["flops"] for k in counter.kernels.values())
    k_bytes = sum(k["bytes"] for k in counter.kernels.values())
    cost = {"flops": float(flops.get_total_flops() + k_flops),
            "bytes accessed": float(counter.bytes + k_bytes),
            "transcendentals": float(counter.transcendentals)}
    colls = ra.collective_stats(counter.collectives)
    terms = ra.roofline_terms(cost, colls, chips, H100_SXM)
    summary = ra.summarize_cell(cfg, shape, terms, chips, H100_SXM,
                                weight_bits=WEIGHT_BITS.get(policy_name, 4.5),
                                quantized_kv=quantized_kv)
    record = {
        "arch": arch, "shape": shape_name, "mesh": list(mesh_shape),
        "chips": chips, "multi_pod": multi_pod, "policy": policy_name,
        "quantized_kv": quantized_kv, "opt_dtype": opt_dtype,
        "attn_impl": cfg.attn_impl, "remat": cfg.remat,
        "decode_impl": cfg.decode_impl,
        "paged": paged, "pool_frac": pool_frac if paged else None,
        "chunked_prefill": chunked_prefill,
        "prefill_chunk": (min(prefill_chunk, shape.seq_len)
                          if chunked_prefill else None),
        "grad_compression": grad_compression, "qat": qat,
        "microbatch": microbatch, "extrapolation": None,
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "prompt_len": prompt_len or None, "reduced": reduced,
        "hw": H100_SXM.name, "build_s": t_build, "run_s": t_run,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias_bytes,
            "peak_nonaliased_bytes": arg_bytes + out_bytes + temp
            - alias_bytes,
        },
        "cost": cost,
        "ops": counter.ops,
        "kernels": counter.kernels,
        "collectives": colls,
        "roofline": summary,
        "params_total": ra.total_param_count(cfg),
        "params_active": ra.active_param_count(cfg),
    }
    if verbose:
        m = record["memory"]
        print(f"--- {arch} x {shape_name} on {mesh_shape} "
              f"(policy={policy_name}) ---")
        print("memory per rank: args %.4f GiB out %.4f GiB temp %.4f GiB "
              "alias %.4f GiB peak %.4f GiB" % tuple(
                  v / 2**30 for v in (m["argument_bytes"], m["output_bytes"],
                                      m["temp_bytes"], m["alias_bytes"],
                                      m["peak_nonaliased_bytes"])))
        print("cost per rank: flops=%.3e bytes=%.3e ops=%d kernels=%s" % (
            cost["flops"], cost["bytes accessed"], counter.ops,
            {k: v["calls"] for k, v in counter.kernels.items()}))
        print("collectives: count=%d wire_bytes/rank=%.3e" %
              (colls["count"], colls["wire_bytes"]))
        print("roofline (%s): compute=%.4fs memory=%.4fs collective=%.4fs "
              "dominant=%s fraction=%.3f" % (
                  H100_SXM.name, summary["t_compute_s"],
                  summary["t_memory_s"], summary["t_collective_s"],
                  summary["dominant"], summary["roofline_fraction"]))
        print("build=%.1fs run=%.1fs" % (t_build, t_run))
    return record


def record_name(record, tag: str = "") -> str:
    name = (f"{record['arch']}__{record['shape']}__"
            f"{'x'.join(map(str, record['mesh']))}")
    return name + (f"__{tag}" if tag else "")


def save_record(record, tag: str = "", out_dir: str = OUT_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, record_name(record, tag) + ".json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="mesh shape, e.g. 16x16 (default; 2x16x16 with "
                         "--multi-pod), 2x2, or 1x1 (one card, unsharded)")
    ap.add_argument("--policy", default="mixed")
    ap.add_argument("--quantized-kv", action="store_true")
    ap.add_argument("--opt-dtype", default="posit8")
    ap.add_argument("--attn-impl", default=None)
    ap.add_argument("--decode-impl", default="blocked",
                    choices=["blocked", "flash"],
                    help="recorded only: the port picks its decode kernel "
                         "by device")
    ap.add_argument("--paged", action="store_true",
                    help="decode cells run the continuous engine's decode "
                         "loop over the paged pool instead of the dense "
                         "cache")
    ap.add_argument("--pool-frac", type=float, default=0.25,
                    help="paged pool capacity as a fraction of the "
                         "worst-case batch*max_len token count")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="prefill cells run ONE chunk-prefill step (the "
                         "last chunk of an S-token prompt) instead of the "
                         "monolithic prefill")
    ap.add_argument("--prefill-chunk", type=int, default=256,
                    help="chunk width of the --chunked-prefill cell")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--seq-chunk", type=int, default=None)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compression", default="none")
    ap.add_argument("--no-qat", action="store_true")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="resize the shape's global batch")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="resize the shape's sequence length (max_len of "
                         "a decode cell)")
    ap.add_argument("--prompt-len", type=int, default=0,
                    help="decode cells: ServeEngine.generate's prefill of "
                         "this many tokens, cache padding and one decode "
                         "step (mesh 1x1)")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced (CPU-test) variant")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory of the records")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-extrapolate", action="store_true",
                    help="kept for the reference's flags: every layer "
                         "runs, nothing is extrapolated")
    args = ap.parse_args(argv)
    mesh_shape = tuple(int(x) for x in args.mesh.split("x")) \
        if args.mesh else None

    cells = []
    if args.all:
        for arch, sname, cfg, shp, runnable in all_cells():
            if runnable:
                cells.append((arch, sname))
            else:
                print(f"SKIP {arch} x {sname}: long_500k needs "
                      f"sub-quadratic attention")
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    failures = []
    for arch, sname in cells:
        if args.skip_existing:
            mesh = mesh_shape or ((2, 16, 16) if args.multi_pod else (16, 16))
            name = record_name({"arch": arch, "shape": sname,
                                "mesh": list(mesh)}, args.tag)
            if os.path.exists(os.path.join(args.out, name + ".json")):
                print("skip (exists):", name)
                continue
        try:
            rec = lower_cell(
                arch, sname, multi_pod=args.multi_pod, mesh_shape=mesh_shape,
                policy_name=args.policy, quantized_kv=args.quantized_kv,
                opt_dtype=args.opt_dtype, attn_impl=args.attn_impl,
                remat=args.remat, microbatch=args.microbatch,
                grad_compression=args.grad_compression,
                qat=not args.no_qat, seq_chunk=args.seq_chunk,
                extrapolate=not args.no_extrapolate,
                decode_impl=args.decode_impl,
                paged=args.paged, pool_frac=args.pool_frac,
                chunked_prefill=args.chunked_prefill,
                prefill_chunk=args.prefill_chunk,
                global_batch=args.global_batch, seq_len=args.seq_len,
                prompt_len=args.prompt_len, reduced=args.reduced)
            print("saved", save_record(rec, args.tag, args.out))
        except Exception as e:
            traceback.print_exc()
            failures.append((arch, sname, repr(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"dry-run OK: {len(cells)} cells")


if __name__ == "__main__":
    main()
