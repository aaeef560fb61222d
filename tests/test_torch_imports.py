"""The port stands alone: no JAX, nothing of the JAX package.

``tvqvae_tpu_torch`` and ``chip_smoke.py`` run on a machine without jax,
flax, optax, orbax, PyYAML or scikit-learn. A subprocess imports every submodule and checks
``sys.modules``; a static scan of every import statement catches imports
that only run inside functions.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "tvqvae_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "tvqvae_tpu", "sklearn"}


def _modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_submodule_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r}"
        " or m in ('yaml', 'mlflow'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_the_scan_covers_the_clis_and_the_checkpoint_io():
    assert {"tvqvae_tpu_torch.scripts.train", "tvqvae_tpu_torch.scripts.train_fcn",
            "tvqvae_tpu_torch.scripts.generate", "tvqvae_tpu_torch.scripts.serve",
            "tvqvae_tpu_torch.scripts.evaluate", "tvqvae_tpu_torch.scripts.quality_run",
            "tvqvae_tpu_torch.evaluation.metrics",
            "tvqvae_tpu_torch.evaluation.isolation_forest",
            "tvqvae_tpu_torch.utils.checkpoint", "tvqvae_tpu_torch.utils.logging"} <= set(_modules())


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"
