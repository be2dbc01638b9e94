"""The port's serving bench twins, its examples and its kernel table on
the CPU.

``decode``, ``serve`` and ``e2e`` run through ``repro_torch.benchmarks.run
--only`` at the reference's ``--smoke`` traffic on its reduced config,
with every assertion on tokens, bytes and counts live (a miss raises and
the runner exits non-zero); their JSON goes to a temporary directory.
Each example's ``main`` runs at a tiny size.  The kernel table: every
kernel wrapper under ``src/repro_torch/kernels/`` has a plain version and
the JAX oracle that ``tools/analysis/rules/kernel_oracle.py``'s
``KERNEL_TABLE`` pairs with its reference kernel (read with ``ast``)."""

import ast
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import one_torch_thread  # noqa: E402,F401
from repro_torch.benchmarks import run as bench_run  # noqa: E402

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))


def _rows(capsys):
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    return {ln.split(",")[0]: ln.split(",", 2)[2] for ln in lines[1:]
            if not ln.startswith("#")}


def _fields(derived):
    return dict(kv.split("=", 1) for kv in derived.split(";"))


def test_decode_twin(tmp_path, capsys):
    bench_run.main(["--only", "decode", "--device", "cpu", "--smoke",
                    "--out", str(tmp_path)])
    rows = _rows(capsys)
    assert set(rows) == {
        "decode/generate_bf16_kv", "decode/generate_posit8_kv",
        "decode/generate_posit8_kv_grouped", "decode/flash_kernel_layer",
        "decode/flash_plain_layer", "decode/sdpa_bf16_layer",
        "decode/kv_bytes_per_step"}
    with open(tmp_path / "BENCH_decode.json") as f:
        res = json.load(f)
    kv = res["kv_bytes_per_step"]
    assert kv["bf16_full"] >= 2 * kv["posit8_lenaware"]
    assert kv["posit8_lenaware"] == kv["posit8_lenaware_8x_maxlen"]
    assert res["config"]["device"] == "cpu"
    assert res["config"]["max_len"] == 256 and res["config"]["steps"] == 8


def test_serve_twin(tmp_path, capsys):
    bench_run.main(["--only", "serve", "--device", "cpu", "--smoke",
                    "--out", str(tmp_path)])
    rows = _rows(capsys)
    for name in ("serve/chunked_prefill_p99_step",
                 "serve/disagg_decode_p99_step"):
        assert _fields(rows[name])["met"] in ("0", "1")
    assert _fields(rows["serve/decode_loop_K4"])["dispatches"] == "4"
    with open(tmp_path / "BENCH_serve.json") as f:
        res = json.load(f)
    assert res["config"]["n_req"] == 8
    for key in ("chunked_prefill", "disagg"):
        assert res[key]["static_parity"] is True
        assert isinstance(res[key]["met"], bool)
        assert res[key]["claim"]
    d = res["disagg"]
    assert d["handoff_bytes"] == d["handoff_pages"] * \
        d["handoff_bytes_per_page"]
    assert d["handoffs"] == 4 * d["n_req"] and d["decode_bounces"] == 0
    assert d["trace_events"]["total"] > 0
    assert os.path.exists(tmp_path / "serve_trace.json")
    assert res["prefix_cache"]["prefix_hits"] == 5
    assert res["decode_loop"]["K8"]["decode_dispatches"] == 2
    rec = res["recurrent"]
    assert rec["K1"]["kv_pages_allocated"] == 0
    assert rec["K1"]["state_bytes_per_step_model"] == \
        2 * rec["state_slab_bytes"] * 4


def test_e2e_twin(capsys):
    bench_run.main(["--only", "e2e", "--device", "cpu"])
    rows = _rows(capsys)
    assert set(rows) == {"e2e/fp32_dense", "e2e/packed_posit8",
                         "e2e/packed_mxp_paper"}
    for name in ("e2e/packed_posit8", "e2e/packed_mxp_paper"):
        f = _fields(rows[name])
        assert float(f["traffic_gain"]) > 2.0
        assert 0.0 <= float(f["tv_dist"]) < 0.1


def test_runner_refuses_a_failing_bench(monkeypatch):
    def broken(device, **kw):
        raise AssertionError("a claim missed")
    monkeypatch.setitem(bench_run.BENCHES, "e2e", broken)
    with pytest.raises(SystemExit):
        bench_run.main(["--only", "e2e", "--device", "cpu"])


def test_quickstart_example(tmp_path, capsys):
    from repro_torch.examples import quickstart
    rc = quickstart.main(["--device", "cpu", "--steps", "8", "--seq", "32",
                          "--batch", "8", "--min-drop", "0",
                          "--ckpt", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "generated:" in out and out.rstrip().endswith("OK")
    assert "bitwise: True" in out


def test_train_lm_example(tmp_path, capsys):
    from repro_torch.examples import train_lm
    rc = train_lm.main(["--reduced", "--device", "cpu", "--steps", "20",
                        "--seq", "32", "--batch", "4", "--log-every", "5",
                        "--ckpt", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.rstrip().endswith("OK")
    assert train_lm.model_config().param_count() > 90e6


@pytest.mark.parametrize("flags", [[], ["--continuous"],
                                   ["--disagg", "--decode-steps", "4"]],
                         ids=["vio", "continuous", "disagg"])
def test_vio_serve_example(flags, capsys):
    from repro_torch.examples import vio_serve
    rc = vio_serve.main(["--device", "cpu", "--steps", "20", *flags])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "mxp(eq.1-2)" in out and out.rstrip().endswith("OK")
    if flags:
        assert "served 7 streams" in out
    if "--disagg" in flags:
        assert "0 decode bounces" in out


def _kernel_table():
    path = os.path.join(ROOT, "tools", "analysis", "rules",
                        "kernel_oracle.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.AnnAssign) and \
                getattr(node.target, "id", None) == "KERNEL_TABLE":
            return ast.literal_eval(node.value)
    raise AssertionError("KERNEL_TABLE not found")


def _defs(path):
    with open(path) as f:
        return {n.name for n in ast.parse(f.read()).body
                if isinstance(n, ast.FunctionDef)}


def _module_of(kernel):
    """The reference module (file name) that defines ``kernel``."""
    d = os.path.join(ROOT, "src", "repro", "kernels")
    hits = [fn for fn in sorted(os.listdir(d)) if fn.endswith(".py")
            and kernel in _defs(os.path.join(d, fn))]
    assert len(hits) == 1, (kernel, hits)
    return hits[0]


def test_kernel_table_pairs_every_wrapper():
    """Each reference kernel ``X_pallas`` of the table has a port wrapper
    ``X`` in the module of the same name, with a plain version
    ``X_plain`` beside it and a launch counter; the port's ``ref.py``
    and the reference's both define the oracle the table names, and the
    reference's fallback the table names exists.  No port wrapper is
    left out of the table (the route counters ``wide_route``,
    ``stream_route`` and ``wgmma_route`` count launches of one route of a
    wrapper beside its own count; ``paged_kv_write`` ports no Pallas
    kernel)."""
    import importlib
    table = _kernel_table()
    assert len(table) == 6
    port_ref = _defs(os.path.join(ROOT, "src", "repro_torch", "kernels",
                                  "ref.py"))
    jax_ref = _defs(os.path.join(ROOT, "src", "repro", "kernels", "ref.py"))
    wrappers = set()
    for kernel, (oracle, fb_path, fb_def) in table.items():
        assert kernel.endswith("_pallas")
        name = kernel[: -len("_pallas")]
        module = _module_of(kernel)
        port_path = os.path.join(ROOT, "src", "repro_torch", "kernels",
                                 module)
        defs = _defs(port_path)
        assert name in defs and f"{name}_plain" in defs, (name, module)
        mod = importlib.import_module(f"repro_torch.kernels.{module[:-3]}")
        assert isinstance(getattr(mod, name).launches, int)
        assert oracle in jax_ref and oracle in port_ref, oracle
        assert fb_def in _defs(os.path.join(ROOT, fb_path)), fb_def
        wrappers.add((module, name))
    # every launch-counted wrapper of the port is in the table
    kdir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    counted = set()
    for fn in sorted(os.listdir(kdir)):
        if not fn.endswith(".py"):
            continue
        with open(os.path.join(kdir, fn)) as f:
            for node in ast.parse(f.read()).body:
                if isinstance(node, ast.Assign) and isinstance(
                        node.targets[0], ast.Attribute) and \
                        node.targets[0].attr == "launches":
                    counted.add((fn, node.targets[0].value.id))
    # kernels with no Pallas counterpart stay out of the table; each
    # one's source says so
    no_tpu = {("kv_write.py", "paged_kv_write")}
    for fn, _ in no_tpu:
        with open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                               fn[:-3] + ".cu")) as f:
            assert "Replaces no TPU kernel" in f.read(), fn
    assert counted - {("flash_decode.py", "wide_route"),
                      ("rmmec_matmul.py", "stream_route"),
                      ("rmmec_matmul.py", "wgmma_route")} - no_tpu \
        == wrappers
