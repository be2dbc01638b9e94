"""The port's dry run (``launch/specs.py``, ``launch/dryrun.py``,
``launch/hillclimb.py``, ``roofline/report.py``) on the CPU.

In process: every ``specs`` function's leaves equal the reference's
``jax.eval_shape`` leaves in path, shape and dtype for the ten configs
and every kind (dense, quantized, paged, chunk, handoff), with the
reference's refusals; ``handoff_specs`` bytes are ``n_pages *
page_handoff_bytes``.

In a subprocess (the fake process group is process-wide): at mesh 1x1 a
reduced float32 train step's FLOPs equal ``FlopCounterMode`` on a real
CPU run of the same step; a packed decode step counts one op per RMMEC
call with exactly the operand bytes of the real run's calls; on a 2x2
fake mesh the argument bytes of rank 0 are the sum of its shards by
``param_sharding_tree`` and the batch layout; qwen2-0.5b ``decode_32k``
on 16x16 against the committed reference record; the hillclimb ladder
and the report on reduced configs.  ``repro.launch.dryrun`` itself is
never imported here: it sets ``XLA_FLAGS`` at import."""

import dataclasses
import json
import math
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import one_torch_thread  # noqa: E402,F401
from repro.configs import get_config as jget  # noqa: E402
from repro.core.policy import flatten_with_paths as jflat  # noqa: E402
from repro.launch import specs as jsp  # noqa: E402
from repro.serve.paged_kv import page_handoff_bytes as j_handoff  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, RunConfig, get_config  # noqa: E402
from repro_torch.core.policy import (PrecisionPolicy,  # noqa: E402
                                     flatten_with_paths)
from repro_torch.launch import specs as sp  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.serve.paged_kv import page_handoff_bytes  # noqa: E402

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
REF_RECORD = os.path.join(ROOT, "artifacts", "dryrun",
                          "qwen2-0.5b__decode_32k__16x16.json")


def _jax_leaves(tree):
    return {p: (tuple(x.shape), str(x.dtype)) for p, x in jflat(tree)}


def _leaves(tree):
    return {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in flatten_with_paths(tree)}


def _pair(arch):
    return get_config(arch).reduced(), jget(arch).reduced()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference(arch):
    cfg, ref = _pair(arch)
    for labels in (True, False):
        assert _leaves(sp.batch_specs(cfg, 2, 16, labels)) == \
            _jax_leaves(jsp.batch_specs(ref, 2, 16, labels))
    for qkv in (False, True):
        for group in (None, 16):
            assert _leaves(sp.cache_specs(cfg, 2, 64, qkv, group)) == \
                _jax_leaves(jsp.cache_specs(ref, 2, 64, qkv, group))
    for name, shape in SHAPES.items():
        small = dataclasses.replace(shape, seq_len=64, global_batch=2)
        assert _leaves(sp.input_specs(cfg, small)) == \
            _jax_leaves(jsp.input_specs(ref, _jshape(name, 64, 2)))
    if cfg.frontend != "none":
        return
    for group in (None, 16):
        for page in (None, 16):
            got = sp.paged_cache_specs(cfg, 2, 64, 0.5, group, page)
            want = jsp.paged_cache_specs(ref, 2, 64, 0.5, group, page)
            assert _leaves(got) == _jax_leaves(want), (group, page)
    assert _leaves(sp.chunk_prefill_specs(cfg, 16, 48)) == \
        _jax_leaves(jsp.chunk_prefill_specs(ref, 16, 48))
    for group in (None, 16):
        got = sp.handoff_specs(cfg, 3, 16, group)
        assert _leaves(got) == _jax_leaves(jsp.handoff_specs(ref, 3, 16,
                                                             group))
        nbytes = sum(t.numel() * t.element_size() for t in got.values())
        assert nbytes == 3 * page_handoff_bytes(cfg, 16, group) \
            == 3 * j_handoff(ref, 16, group)


def _jshape(name, seq, batch):
    from repro.configs import SHAPES as JSHAPES
    return dataclasses.replace(JSHAPES[name], seq_len=seq,
                               global_batch=batch)


def test_specs_refusals_equal_reference():
    cfg, ref = _pair("qwen2-0.5b")
    with pytest.raises(ValueError) as got:
        sp.paged_cache_specs(cfg, 2, 64, page_size=24)
    with pytest.raises(ValueError) as want:
        jsp.paged_cache_specs(ref, 2, 64, page_size=24)
    assert str(got.value) == str(want.value)
    odd, jodd = (dataclasses.replace(c, family="conv") for c in (cfg, ref))
    for fn, jfn in ((lambda c: sp.handoff_specs(c, 1, 16),
                     lambda c: jsp.handoff_specs(c, 1, 16)),
                    (lambda c: sp.paged_cache_specs(c, 2, 64),
                     lambda c: jsp.paged_cache_specs(c, 2, 64))):
        with pytest.raises(ValueError) as got:
            fn(odd)
        with pytest.raises(ValueError) as want:
            jfn(jodd)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the dry run, in a subprocess
# ---------------------------------------------------------------------------

def _dryrun(tmp_path, *flags):
    """Run the dry run's CLI on one cell; returns its record."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = tmp_path / "records"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
         str(out), *flags], capture_output=True, text=True, env=env,
        timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    (path,) = out.glob("*.json")
    with open(path) as f:
        return json.load(f)


def test_train_flops_equal_a_real_run(tmp_path):
    """Mesh 1x1, reduced float32 qwen2, no QAT: the fake step's FLOPs
    are ``FlopCounterMode``'s on the real step."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.data.tokens import TokenStream
    from repro_torch.train.loop import build_train_step, init_state
    rec = _dryrun(tmp_path, "--arch", "qwen2-0.5b", "--shape", "train_4k",
                  "--reduced", "--mesh", "1x1", "--policy", "fp32",
                  "--no-qat", "--global-batch", "4", "--seq-len", "32",
                  "--microbatch", "2")
    cfg = get_config("qwen2-0.5b").reduced()
    run = RunConfig(qat=False, precision_policy="fp32",
                    opt_state_dtype="posit8", microbatch=2)
    state = init_state(cfg, run, torch.Generator().manual_seed(0))
    step = build_train_step(cfg, run, PrecisionPolicy.uniform("fp32"))
    batch = TokenStream(vocab=cfg.vocab, seq_len=32, global_batch=4,
                        device="cpu").next_batch()
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    assert rec["cost"]["flops"] == fc.get_total_flops() > 0
    assert rec["kernels"] == {}
    assert rec["chips"] == 1 and rec["collectives"]["count"] == 0
    # the arguments are the state and the global batch
    n = sum(t.numel() * t.element_size()
            for _, t in flatten_with_paths((state, batch)))
    assert rec["memory"]["argument_bytes"] == n
    assert rec["memory"]["peak_nonaliased_bytes"] > n


def test_packed_decode_counts_each_kernel_call(tmp_path, monkeypatch):
    """Each RMMEC and flash-decode call of a packed decode step is one op
    with the FLOPs and the operand and output bytes of the same call in
    the real step (the decode attention reads the live prefix)."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    from repro_torch.serve.engine import build_serve_step
    rec = _dryrun(tmp_path, "--arch", "qwen2-0.5b", "--shape", "decode_32k",
                  "--reduced", "--mesh", "1x1", "--quantized-kv",
                  "--global-batch", "2", "--seq-len", "64")
    cfg = get_config("qwen2-0.5b").reduced()
    params = zoo.init_model(cfg, torch.Generator().manual_seed(0),
                            policy=PrecisionPolicy.paper_mixed())
    params["embed"]["table"] = params["embed"]["table"].to(torch.bfloat16)
    calls = {"rmmec_matmul": [], "flash_decode": []}
    rmmec, flash = ops.rmmec_matmul, attention.flash_decode

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def rmmec_counted(x, words, scales, mask, spec, n=None):
        out = rmmec(x, words, scales, mask, spec, n)
        calls["rmmec_matmul"].append((2.0 * x.shape[0] * x.shape[1]
                                      * out.shape[1],
                                      nbytes(x, words, scales, mask, out)))
        return out

    def flash_counted(q, kc, ks, vc, vs, pos, pad=None, *a, **kw):
        out = flash(q, kc, ks, vc, vs, pos, pad, *a, **kw)
        live = pos + 1
        cut = [t[:, :live] for t in (kc, ks, vc, vs)]
        calls["flash_decode"].append((4.0 * q.numel() * live,
                                      nbytes(q, pad, out, *cut)))
        return out
    monkeypatch.setattr(ops, "rmmec_matmul", rmmec_counted)
    monkeypatch.setattr(attention, "flash_decode", flash_counted)
    cache = sp.cache_specs(cfg, 2, 64, True, device="cpu")
    build_serve_step(cfg)(params, torch.zeros((2, 1), dtype=torch.int32),
                          cache, 63, None, None, 0.0)
    assert len(calls["rmmec_matmul"]) == 7 * cfg.n_layers
    assert len(calls["flash_decode"]) == cfg.n_layers
    for name, got in calls.items():
        k = rec["kernels"][name]
        assert k["calls"] == len(got), name
        assert k["flops"] == sum(f for f, _ in got), name
        assert k["bytes"] == sum(b for _, b in got), name
    assert set(rec["kernels"]) == set(calls)
    assert rec["cost"]["flops"] > sum(k["flops"]
                                      for k in rec["kernels"].values())


def _local_bytes(shape, spec, axes, itemsize):
    n = 1
    for d, e in zip(shape, spec):
        names = (e,) if isinstance(e, str) else (e or ())
        n *= d // math.prod(axes[a] for a in names)
    return n * itemsize


def test_argument_bytes_are_the_rank_shards(tmp_path):
    """2x2 fake mesh, a reduced packed prefill: rank 0 holds its shards
    of every parameter by ``param_sharding_tree`` and its rows of the
    batch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rec = _dryrun(tmp_path, "--arch", "qwen2-0.5b", "--shape",
                  "prefill_32k", "--reduced", "--mesh", "2x2",
                  "--global-batch", "4", "--seq-len", "64")
    cfg = get_config("qwen2-0.5b").reduced()
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((2, 2)))
    axes = {"data": 2, "model": 2}
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = zoo.init_model(cfg, torch.Generator().manual_seed(0),
                                policy=PrecisionPolicy.paper_mixed())
        leaves = flatten_with_paths(params)
        specs = dict(flatten_with_paths(sh.param_sharding_tree(mesh,
                                                               params)))
        want = sum(_local_bytes(t.shape, specs[p].spec, axes,
                                t.element_size()) for p, t in leaves)
    want += 4 // 2 * 64 * 4            # int32 tokens, rows over 'data'
    assert rec["memory"]["argument_bytes"] == want
    assert rec["chips"] == 4 and rec["mesh"] == [2, 2]
    assert rec["collectives"]["all-gather"] > 0


def test_qwen2_decode_32k_against_the_reference_record(tmp_path):
    """qwen2-0.5b ``decode_32k`` on 16x16 with the reference record's
    settings (policy mixed, dense bf16 cache, not paged).  XLA prunes
    arguments a program never reads, and the reference's decode reads no
    block mask, so its record counts none of the seven (24, 1, 1) int32
    masks; the port's RMMEC kernel reads them.  The port's ``pos`` is a
    host integer, the reference's a 4-byte device scalar.  Those leaves
    aside the bytes are equal."""
    with open(REF_RECORD) as f:
        ref = json.load(f)
    assert (ref["policy"], ref["quantized_kv"], ref["paged"]) == \
        ("mixed", False, False)
    rec = _dryrun(tmp_path, "--arch", "qwen2-0.5b", "--shape", "decode_32k",
                  "--policy", "mixed")
    masks = 7 * 24 * 1 * 1 * 4
    pos = 4
    assert ref["memory"]["argument_bytes"] == 205_741_348
    got = rec["memory"]["argument_bytes"]
    assert got == ref["memory"]["argument_bytes"] + masks - pos
    assert abs(got / ref["memory"]["argument_bytes"] - 1) < 0.005
    # the reference's record keys, every one
    for key in ref:
        if key in ("lower_s", "compile_s"):
            continue
        assert key in rec, key
    for part in ("memory", "collectives", "roofline"):
        assert set(ref[part]) <= set(rec[part]), part
    assert rec["extrapolation"] is None and rec["hw"] == "h100_sxm"
    assert rec["params_total"] == ref["params_total"]
    assert rec["roofline"]["model_flops"] == ref["roofline"]["model_flops"]
    assert rec["roofline"]["min_traffic_bytes"] == \
        ref["roofline"]["min_traffic_bytes"]
    # every projection of every layer through the kernel, none plain
    assert rec["kernels"]["rmmec_matmul"]["calls"] == 7 * 24


def test_hillclimb_and_report(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = tmp_path / "hc"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.hillclimb", "--cell", "B",
         "--mesh", "1x1", "--reduced", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(x) for x in open(out / "perf_log.jsonl")]
    assert [r["tag"] for r in rows] == ["hc0", "hc_lastlogit", "hc_chunk"]
    names = sorted(p.name for p in out.glob("*.json"))
    assert names == [f"qwen2-0.5b__prefill_32k__1x1__{t}.json"
                     for t in ("hc0", "hc_chunk", "hc_lastlogit")]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.roofline.report", "--dir",
         str(out), "--tag", "hc0", "--mesh", "1x1"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "| qwen2-0.5b | prefill_32k | 1x1 | mixed |" in proc.stdout
    assert "cells: 1 baselined" in proc.stdout
