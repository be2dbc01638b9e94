"""The port's launch CLIs against the reference's: the flag sets of
``repro_torch.launch.serve`` and ``repro_torch.launch.train`` contain
every flag of ``repro.launch.serve`` / ``repro.launch.train`` (read from
their ``--help`` in a subprocess), and on the CPU with a reduced config
``--paged`` runs the continuous engine, ``--trace OUT.json`` writes a
Chrome trace, ``--metrics`` prints the Prometheus snapshot and the
static path prints the reference's note for both; the train CLI takes
the audio and vision configs."""

import json
import os
import re
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import one_torch_thread  # noqa: E402,F401

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
_FLAG = re.compile(r"(?<![\w-])--[a-z][a-z0-9-]*")


def _help(module: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", module, "--help"],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("name", ["serve", "train"])
def test_flags_contain_the_reference_flags(name):
    want = set(_FLAG.findall(_help(f"repro.launch.{name}")))
    got = set(_FLAG.findall(_help(f"repro_torch.launch.{name}")))
    assert {"--arch", "--reduced"} <= want
    assert want <= got, sorted(want - got)
    if name == "serve":
        assert {"--paged", "--trace", "--metrics"} <= got


def _serve(monkeypatch, capsys, *flags):
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--reduced", "--batch", "2",
        "--prompt-len", "12", "--steps", "4", *flags])
    serve.main()
    return capsys.readouterr().out


def test_paged_trace_and_metrics(monkeypatch, capsys, tmp_path):
    path = tmp_path / "trace.json"
    out = _serve(monkeypatch, capsys, "--paged", "--n-pages", "8",
                 "--prefill-chunk", "16", "--trace", str(path), "--metrics")
    assert "served 4 requests" in out and "pool:" in out
    assert "slo (ms):" in out and f"to {path}" in out
    trace = json.loads(path.read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"SUBMIT", "ADMIT", "RETIRE"} <= names
    assert "# TYPE repro_engine_steps_run" in out
    assert "note:" not in out


def test_disagg_metrics(monkeypatch, capsys):
    out = _serve(monkeypatch, capsys, "--disagg", "--n-pages", "8",
                 "--prefill-chunk", "16", "--metrics")
    assert "disagg:" in out and "# TYPE repro_" in out


def test_static_path_prints_the_note(monkeypatch, capsys, tmp_path):
    path = tmp_path / "never.json"
    out = _serve(monkeypatch, capsys, "--trace", str(path), "--metrics")
    assert out.startswith("note: --trace/--metrics need the paged engines "
                          "(--continuous/--disagg); the static engine "
                          "carries no telemetry")
    assert "generated (2, 16)" in out and not path.exists()


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-7b"])
def test_train_cli_takes_the_frontend_configs(arch, tmp_path, capsys):
    """``TokenStream(frontend=...)`` feeds frame / patch embeddings through
    the train CLI on the CPU, and the loss is finite."""
    from repro_torch.launch import train as cli
    cli.main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
              "--seq", "16", "--policy", "mixed", "--qat",
              "--checkpoint-dir", str(tmp_path / "ck"), "--device", "cpu"])
    out = capsys.readouterr().out
    loss = float(re.search(r"final loss: (\S+)", out).group(1))
    assert loss == loss and "at step 2 on cpu" in out
