"""A whole run on the CPU at a tiny size, past the harness's look for a
card: sound, with the timed path broken underneath (``correct`` must
come out false), and with the lower-precision control in the program's
place.  One card serves a cell, so no fault of an exchange between
cards applies."""

from __future__ import annotations

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import harness
from bench.reference import compare
from bench.reference.common import fp8_rows

from _bench_tiny import small_traffic, tiny_cell

CELLS = ["deepseek-67b.chat", "jamba-v0.1-52b.chat"]
SEED = 2**31 + 11
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _run(name, fault=None):
    with pytest.MonkeyPatch.context() as mp:
        torch.set_num_threads(1)
        small_traffic(mp)
        if fault is not None:
            fault(mp)
        cell = tiny_cell(name)
        res = harness.run_cell(cell, SEED, 2.0, False, "cpu",
                               log=lambda m: None)
        chk = harness.check(cell, SEED, res["served"], "cpu")
    return cell, res, chk


@pytest.fixture(scope="module")
def sound():
    return {name: _run(name) for name in CELLS}


def altered_token(mp):
    """Every sampled token replaced by its neighbour id."""
    from repro_torch.serve import engine
    orig = engine.sample_tokens
    mp.setattr(engine, "sample_tokens",
               lambda lg, *a: (orig(lg, *a) + 1) % lg.shape[-1])


def state_unchanged(mp):
    """No token's key and value reaches the paged pool, and a decoded
    token leaves the recurrent state as it found it."""
    from repro_torch.models import attention, ssm
    mp.setattr(attention, "_pool_write", lambda *a, **k: None)
    mp.setattr(ssm, "requantize_state", lambda state, state_q: state_q)


def half_batch(mp):
    """The decode forward's second half of rows left out: they are
    served the first half's logits."""
    from repro_torch.models import zoo
    orig = zoo.decode_model

    def decode(params, tokens, cfg, cache, pos, pad=None):
        lg, cache = orig(params, tokens, cfg, cache, pos, pad)
        h = lg.shape[0] // 2
        lg = lg.clone()
        lg[h:] = lg[:lg.shape[0] - h]
        return lg, cache

    mp.setattr(zoo, "decode_model", decode)


@pytest.mark.parametrize("fault", [altered_token, state_unchanged,
                                   half_batch], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(sound, name, fault):
    cell, res, chk = _run(name, fault)
    assert res["attempted"] > 0 and chk["compared_tokens"] > 0
    assert not harness.is_correct(harness.verdict(cell, res, chk))
    assert chk["mean_logit_gap"] > 3 * sound[name][2]["mean_logit_gap"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_records_the_window(sound, name):
    cell, res, chk = sound[name]
    rec = res["record"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert chk["compared_tokens"] >= 2 and chk["compared_requests"] >= 1
    assert harness.read_metric("output_tok_s", rec) > 0
    assert harness.read_metric("setup_s", rec) > 0
    assert len(rec["steps"]) > 3


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(sound, name, seed):
    """The reference itself in the program's place at the next precision
    below the configuration's (float8 inputs to every product, logits in
    bfloat16 as the read-out writes them), read at every position of
    teacher-forced sequences, moves tokens, and reads more than three
    times what a sound run of the program reads at the same size: the
    rule that sets a cell's limits (at a vocabulary of 4096: near-ties
    need many candidates).  The cells' limits hold at their own sizes,
    where the chip reads both sides."""
    cell = tiny_cell(name)
    m = cell["cfg"]["model"]
    m["vocab"] = 4096
    ref = importlib.import_module(f"bench.reference.{cell['cfg']['reference']}")
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(0, 4096, 32), rng.integers(0, 4096, 128))
            for _ in range(2)]
    full = ref.logits(m, seed, reqs, "cpu")
    low = ref.logits(m, seed, reqs, "cpu", act=fp8_rows)
    checked = harness.gap_readings(
        compare.control_gaps(full, low),
        compare.control_gaps(full, low, compare.READOUT))
    ok = sound[name][2]
    assert checked["off_share_bf16"] > 0.01
    for k in ("mean_logit_gap", "mean_logit_gap_bf16"):
        assert checked[k] > 3 * ok[k]


def test_one_layer_of_the_reference_is_the_served_model_bit_for_bit():
    """At one layer the dense reference rounds where the served model
    does: its logits rounded to bfloat16 are the program's, bit for bit,
    at every served token of a tiny run (deeper, the two sum in other
    orders and part by rounding)."""
    from repro_torch.serve import engine
    rows = {}
    orig = engine.sample_tokens

    def record(lg, temperature, seed, rids, gen_idx):
        for i in range(lg.shape[0]):
            rows[(int(rids[i]), int(gen_idx[i]))] = lg[i].float().clone()
        return orig(lg, temperature, seed, rids, gen_idx)

    with pytest.MonkeyPatch.context() as mp:
        torch.set_num_threads(1)
        small_traffic(mp)
        mp.setattr(engine, "sample_tokens", record)
        cell = tiny_cell("deepseek-67b.chat")
        cell["cfg"]["model"]["n_layers"] = 1
        res = harness.run_cell(cell, SEED, 2.0, False, "cpu",
                               log=lambda m: None)
    done = [r for r in res["served"] if len(r["served"])][:4]
    ref = importlib.import_module("bench.reference.llama")
    lg = ref.logits(cell["cfg"]["model"], SEED,
                    [(r["prompt"], r["served"]) for r in done], "cpu")
    assert done
    for r, want in zip(done, lg):
        got = torch.stack([rows[(r["rid"], i)]
                           for i in range(len(r["served"]))])
        assert torch.equal(got, want.to(compare.READOUT).float())


def test_run_without_a_card_prints_no_result(tmp_path):
    """No card here: a non-zero exit and nothing on standard output,
    in the checkout and in a folder that holds only the benchmark."""
    import shutil
    shutil.copytree(os.path.join(ROOT, "bench"), tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for where in (ROOT, str(tmp_path)):
        out = subprocess.run(
            [sys.executable, "bench/run.py", "--workload",
             "deepseek-67b.chat", "--seed", str(SEED), "--seconds", "1",
             "--trace", "0"], cwd=where, capture_output=True, text=True,
            timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0 and out.stdout == "", out.stderr[-500:]
