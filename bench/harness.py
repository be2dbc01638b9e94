"""One run of one cell: set the program up from the cell's files, drive
the closed loop, reduce what was recorded to the cell's metrics, and
hold the served tokens against the plain reference.

Everything that belongs to one configuration, traffic mix, cell or
metric is found by its name: ``configs/<config>.json`` (its ``model``
sizes in the program's terms, its ``reference`` module),
``traffic/<mix>.json``, ``cells/<cell>.json`` (engine settings and the
correctness check's limits) and ``metrics/<metric>.py``."""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import loop, roofline, traffic
from .reference import compare, weights

__all__ = ["HERE", "load_cell", "build_params", "run_cell", "read_metric",
           "metrics_of", "process_start"]

HERE = os.path.dirname(os.path.abspath(__file__))
PROFILE_S = 3.0         # the profiler's stretch after a traced window
SAMPLE_TOKENS = 1600    # the check compares requests until this many
SAMPLE_REQUESTS = 16    # served tokens are covered, or this many requests


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell's file with its configuration's file under "cfg"."""
    cell = _json("cells", f"{name}.json")
    cell["cfg"] = _json("configs", f"{cell['config']}.json")
    return cell


def metrics_of(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a ``--trace`` 0 or 1 run of ``cell`` reports: an
    end-to-end metric where it lists the cell or lists none; a per-layer
    metric where it lists the cell, or lists none and the cell reports
    the metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def read_metric(name: str, record: dict) -> Optional[float]:
    """``metrics/<name>.py``'s ``read(record)``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def _stacked(first, depth: int):
    """Empty (depth, ...) buffers shaped like a one-slice packed tree."""
    from repro_torch.kernels.ops import PackedTensor
    if isinstance(first, dict):
        return {k: _stacked(v, depth) for k, v in first.items()}
    if isinstance(first, PackedTensor):
        return dataclasses.replace(first, **{
            f: getattr(first, f).new_empty(
                (depth,) + tuple(getattr(first, f).shape[1:]))
            for f in ("words", "scales", "mask")})
    return first.new_empty((depth,) + tuple(first.shape[1:]))


def _put(dst, i: int, src) -> None:
    from repro_torch.kernels.ops import PackedTensor
    if isinstance(src, dict):
        for k, v in src.items():
            _put(dst[k], i, v)
    elif isinstance(src, PackedTensor):
        for f in ("words", "scales", "mask"):
            getattr(dst, f)[i].copy_(getattr(src, f)[0])
    else:
        dst[i].copy_(src[0])


def _at(tree: dict, path: str, value) -> None:
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def build_params(cfg: dict, seed: int, device) -> dict:
    """The program's parameter tree: every slice drawn from the seed
    (``reference.weights``) and packed by the program under the
    configuration's policy, one slice at a time."""
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models import zoo
    if cfg["policy"] != "paper_mixed":
        raise ValueError(f"no such policy {cfg['policy']!r}")
    policy = PrecisionPolicy.paper_mixed()
    ref = importlib.import_module(f"{__package__}.reference."
                                  f"{cfg['reference']}")
    m = cfg["model"]
    top = weights.draw(seed, "top", ref.top(m), device)
    top["embed/table"] = top["embed/table"].to(torch.bfloat16)
    params = zoo.pack_params(weights.nest(top), policy)
    del top
    for stack, depth, leaves in ref.stacks(m):
        buf = None
        for i in range(depth):
            flat = weights.draw(seed, f"{stack}/{i}", leaves, device)
            one = zoo.pack_params(
                weights.nest({p: t[None] for p, t in flat.items()}), policy,
                prefix=stack)
            del flat
            if buf is None:
                buf = _stacked(one, depth)
            _put(buf, i, one)
            del one
        _at(params, stack, buf)
    return params


def _engine(cell: dict, params: dict, device, rec):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serve.engine import ContinuousEngine
    e = cell["engine"]
    return ContinuousEngine(
        ModelConfig(**cell["cfg"]["model"]), params, n_pages=e["n_pages"],
        page_size=e["page_size"], max_batch=e["max_batch"],
        max_len=e["max_len"], temperature=0.0,
        prefill_chunk_tokens=e["prefill_chunk_tokens"],
        prefill_context=e["prefill_context"],
        prefix_cache=e["prefix_cache"], decode_steps=e["decode_steps"],
        n_state_slabs=e.get("n_state_slabs"), trace=rec, device=device)


def _record(cell, run: loop.Run, setup_s: float, model: roofline.Model,
            steps_extra: Optional[list], profile: Optional[dict],
            spans: Optional[dict]) -> dict:
    t0 = run.t0
    rel = [{"submit": s.submit - t0, "prompt": int(len(s.prompt)),
            "times": [t - t0 for t in s.times]} for s in run.requests]
    by_rid = {s.rid: len(s.prompt) for s in run.requests}
    steps = []
    for i, st in enumerate(run.steps):
        one = {"start": st["start"] - t0, "end": st["end"] - t0,
               "positions": st["positions"],
               "admitted_prompt_tokens": sum(by_rid.get(r, 0)
                                             for r in st["admitted"])}
        if steps_extra is not None:
            one.update(steps_extra[i])
        steps.append(one)
    return {"cell": cell["name"], "max_batch": cell["engine"]["max_batch"],
            "window": [0.0, run.t1 - t0], "setup_s": setup_s,
            "requests": rel, "steps": steps, "counters0": run.counters0,
            "counters1": run.counters1, "unanswered": run.unanswered,
            "model": dataclasses.asdict(model), "profile": profile,
            "spans": spans}


def _spans(rec, t0: float, t1: float) -> dict:
    """Seconds and counts of the engine's spans that began in the
    window."""
    out: Dict[str, list] = {}
    for e in rec.events():
        if e["ph"] != "X":
            continue
        t = rec._t0 + e["ts"]
        if t0 <= t <= t1:
            s = out.setdefault(e["kind"], [0.0, 0])
            s[0] += e["dur"]
            s[1] += 1
    return {k: {"seconds": v[0], "count": v[1]} for k, v in out.items()}


def _rooflines(calls: List[dict], by_kind: Dict[str, Dict[str, float]]):
    out: Dict[str, Dict[str, dict]] = {}
    for c in calls:
        d = out.setdefault(c["kind"], {}).setdefault(
            c["phase"], {"bound_s": 0.0, "calls": 0, "binds": {}})
        t, term = roofline.bound(c["flops"], c["bytes"])
        d["bound_s"] += t
        d["calls"] += 1
        d["binds"][term] = d["binds"].get(term, 0) + 1
    for kind, phases in out.items():
        for phase, d in phases.items():
            d["device_s"] = by_kind.get(kind, {}).get(phase, 0.0)
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None, log=print) -> dict:
    """One run; returns {"record", "served", "memory_peak_bytes",
    "attempted", "failed"} with the program freed."""
    t_start = process_start() if t_start is None else t_start
    cfg = cell["cfg"]
    ref = importlib.import_module(f"{__package__}.reference."
                                  f"{cfg['reference']}")
    model = roofline.Model.of(cfg["model"], ref)
    clients, lead = traffic.make(cell["traffic"], seed, cfg["model"]["vocab"])
    params = build_params(cfg, seed, device)
    rec = None
    if trace:
        from .tracing import BenchRecorder, Profile
        rec = BenchRecorder()
        if torch.device(device).type == "cuda":
            Profile.warm()
    eng = _engine(cell, params, device, rec)
    del params
    log(f"[bench] set up the program in {time.perf_counter() - t_start:.1f}"
        f" s; ramping {len(clients)} clients")
    prof = kcalls = None
    steps_extra: Optional[list] = [] if trace else None
    cuda = torch.device(device).type == "cuda"

    def on_window(event, t):
        if event == "open":
            log(f"[bench] window opens {t - t_start:.1f} s after start")
            if cuda:
                torch.cuda.reset_peak_memory_stats()
        if rec is None:
            return
        if event == "open":
            rec.take_step()
        elif event == "step":
            steps_extra.append(rec.take_step())
        elif event == "extra":
            prof.start()
        elif event == "extra_done":
            prof.stop()

    if trace and cuda:
        from .tracing import KernelCalls, Profile
        prof = Profile(rec)
        kcalls = KernelCalls(rec, eng)
    try:
        run = loop.drive(eng, clients, lead, seconds, on_window=on_window,
                         extra_s=PROFILE_S if prof else 0.0,
                         log=log)
    finally:
        if kcalls is not None:
            kcalls.restore()
    setup_s = run.t0 - t_start
    n_pages = cell["engine"]["n_pages"]
    log(f"[bench] pool pages in use at the window's close: "
        f"{n_pages - run.counters1['pool_pages_free']} of {n_pages}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    profile = spans = None
    if trace:
        spans = _spans(rec, run.t0, run.t1)
        if prof is not None:
            profile = prof.reduce()
            if profile:
                profile["rooflines"] = _rooflines(rec.calls,
                                                  profile.pop("by_kind"))
    record = _record(cell, run, setup_s, model, steps_extra, profile, spans)
    served = [{"rid": s.rid, "prompt": s.prompt, "served": s.served}
              for s in run.requests
              if s.done is not None and run.t0 <= s.done <= run.t1]
    attempted = sum(1 for s in run.requests if run.t0 <= s.submit <= run.t1)
    del eng, run, rec
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return {"record": record, "served": served, "memory_peak_bytes": peak,
            "attempted": attempted, "failed": record["unanswered"]}


def _gap_stats(gaps, prefix: str = "", suffix: str = "") -> dict:
    flat = np.concatenate(gaps)
    return {f"{prefix}max_logit_gap{suffix}": float(flat.max()),
            f"{prefix}mean_logit_gap{suffix}": float(flat.mean())}


def gap_readings(gaps, gaps_readout, prefix: str = "") -> dict:
    """The widest and mean gap on the float32 logits; (``_bf16``) the
    same on the logits in the read-out's precision, and the share of
    tokens whose gap there is not 0."""
    flat = np.concatenate(gaps_readout)
    return dict(_gap_stats(gaps, prefix),
                **_gap_stats(gaps_readout, prefix, "_bf16"),
                **{f"{prefix}off_share_bf16": float((flat > 0).mean())})


def check(cell: dict, seed: int, served: List[dict], device,
          act=None) -> dict:
    """The correctness check of a run's served tokens over a seeded
    sample of the requests finished in the window: the widest and the
    mean logit gap of the served tokens, on the float32 logits and in
    the read-out's precision (``compare``), and how many tokens the
    sample covered.  With ``act`` (a lower precision's rounding) also
    the control's gaps on the same sample, as ``control_...``."""
    cfg = cell["cfg"]
    ref = importlib.import_module(f"{__package__}.reference."
                                  f"{cfg['reference']}")
    picked = compare.sample(served, seed, SAMPLE_TOKENS, SAMPLE_REQUESTS)
    out = {"compared_tokens": sum(len(r["served"]) for r in picked),
           "compared_requests": len(picked)}
    if not picked:
        inf = float("inf")
        return dict(out, max_logit_gap=inf, mean_logit_gap=inf,
                    max_logit_gap_bf16=inf, mean_logit_gap_bf16=inf)
    reqs = [(r["prompt"], r["served"]) for r in picked]
    toks = [r["served"] for r in picked]
    lg = ref.logits(cfg["model"], seed, reqs, device, cfg["policy"])
    gaps = compare.served_gaps(lg, toks)
    gaps16 = compare.served_gaps(lg, toks, compare.READOUT)
    out.update(gap_readings(gaps, gaps16))
    out["requests"] = [
        {"rid": r["rid"], "prompt": len(r["prompt"]), "served": len(g),
         "off": int((g > 0).sum()), "off_bf16": int((g16 > 0).sum()),
         "sum": float(g.sum()), "max": float(g.max()),
         "max_bf16": float(g16.max()), "at": int(g.argmax())}
        for r, g, g16 in zip(picked, gaps, gaps16)]
    if act is not None:
        low = ref.logits(cfg["model"], seed, reqs, device, cfg["policy"],
                         act=act)
        out.update(gap_readings(compare.control_gaps(lg, low),
                               compare.control_gaps(lg, low, compare.READOUT),
                               "control_"))
    return out


def verdict(cell: dict, result: dict, checked: dict) -> Dict[str, dict]:
    """Each compared number beside its limit: the cell's gap limits (an
    upper limit each), the least number of compared tokens, and no
    request of the window left without its first token."""
    out = {name: {"value": checked[name], "limit": lim}
           for name, lim in cell["check"]["limits"].items()}
    out["unanswered"] = {"value": result["failed"], "limit": 0}
    return out


def is_correct(checks: Dict[str, dict]) -> bool:
    """Every gap and the unanswered count at or under its limit, at
    least ``compared_tokens`` tokens compared; a limit not yet set
    fails."""
    for name, c in checks.items():
        if c["limit"] is None:
            return False
        ok = c["value"] >= c["limit"] if name == "compared_tokens" \
            else c["value"] <= c["limit"]
        if not ok:
            return False
    return True
