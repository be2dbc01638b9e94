"""The PyTorch port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports jax or the JAX package, and importing the port
leaves both out of ``sys.modules``."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(files)


def _banned(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "repro" \
        or name.startswith("repro.")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [] if node.level else [node.module or ""]
        else:
            continue
        bad = [n for n in names if _banned(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_import_leaves_jax_and_reference_unloaded():
    code = ("import sys, repro_torch.serve.engine, repro_torch.launch.serve, "
            "repro_torch.bridge, repro_torch.serve.scheduler, "
            "repro_torch.serve.paged_kv, repro_torch.obs, "
            "repro_torch.core.npe, repro_torch.core.quire, "
            "repro_torch.kernels.codec, repro_torch.kernels.quire_dot, "
            "repro_torch.benchmarks.run, repro_torch.serve.disagg, "
            "repro_torch.core.qat, repro_torch.core.sensitivity, "
            "repro_torch.optim, repro_torch.data.vio_data, "
            "repro_torch.models.perception, repro_torch.models.ssm, "
            "repro_torch.models.moe, repro_torch.models.transformer, "
            "repro_torch.train.loop, repro_torch.checkpoint, "
            "repro_torch.data.tokens, repro_torch.parallel.collectives, "
            "repro_torch.launch.train, repro_torch.launch.mesh, "
            "repro_torch.parallel.sharding, repro_torch.parallel.pipeline\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(','.join(bad))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
