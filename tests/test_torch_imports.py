"""The port stands alone: no JAX, nothing of the JAX package.

``tvqvae_tpu_torch`` and ``chip_smoke.py`` run on a machine without jax,
flax, optax, orbax, PyYAML or scikit-learn, and the port keeps its tables in
numpy, not pandas. A subprocess imports every submodule and checks
``sys.modules``; a static scan of every import statement catches imports
that only run inside functions. pandas may appear only as an optional
extra: inside a ``try`` whose handler catches ``ImportError`` (the generate
CLI's Traffic pickle, which needs the ``traffic`` package anyway).
matplotlib, which the card's machine lacks too, is imported only inside
the functions that draw, so every figure's data is computed without it.
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
OPTIONAL = {"pandas"}  # forbidden unless guarded by ``except ImportError``
DRAWING = {"matplotlib"}  # imported inside functions only


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
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN | OPTIONAL)!r}"
        f" or m.split('.')[0] in {sorted(DRAWING)!r} or m in ('yaml', 'mlflow'))\n"
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
            "tvqvae_tpu_torch.evaluation.flyability.distances",
            "tvqvae_tpu_torch.evaluation.flyability.bluesky",
            "tvqvae_tpu_torch.evaluation.flyability.sowd",
            "tvqvae_tpu_torch.scripts.evaluate_flyability",
            "tvqvae_tpu_torch.data.preprocess",
            "tvqvae_tpu_torch.ops.traj_dp_kernel", "tvqvae_tpu_torch.ops.frechet_kernel",
            "tvqvae_tpu_torch.ops.nvcc",
            "tvqvae_tpu_torch.utils.checkpoint", "tvqvae_tpu_torch.utils.logging",
            "tvqvae_tpu_torch.utils.import_reference", "tvqvae_tpu_torch.scripts.import_ckpt",
            "tvqvae_tpu_torch.utils.profiling", "tvqvae_tpu_torch.utils.embedding",
            "tvqvae_tpu_torch.utils.plots", "tvqvae_tpu_torch.scripts.analyze",
            "tvqvae_tpu_torch.parallel", "tvqvae_tpu_torch.parallel.mesh"} <= set(_modules())


def _guarded_by_import_error(node, parents) -> bool:
    """Whether ``node`` sits in the body of a ``try`` with an ``except``
    naming ImportError (or ModuleNotFoundError)."""
    while node in parents:
        parent = parents[node]
        if isinstance(parent, ast.Try) and node in parent.body:
            for h in parent.handlers:
                names = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
                if any(isinstance(n, ast.Name) and n.id in ("ImportError", "ModuleNotFoundError")
                       for n in names):
                    return True
        node = parent
    return False


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    parents = {child: node for node in ast.walk(tree) for child in ast.iter_child_nodes(node)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"
            assert top not in OPTIONAL or _guarded_by_import_error(node, parents), \
                f"{path}:{node.lineno} imports {name} outside an optional-import guard"
            assert top not in DRAWING or _inside_function(node, parents), \
                f"{path}:{node.lineno} imports {name} outside a function"


def _inside_function(node, parents) -> bool:
    while node in parents:
        node = parents[node]
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return True
    return False


def test_an_import_inside_a_function_is_recognised():
    tree = ast.parse("import matplotlib\ndef f():\n    import matplotlib.pyplot\n")
    parents = {c: n for n in ast.walk(tree) for c in ast.iter_child_nodes(n)}
    got = [_inside_function(n, parents) for n in ast.walk(tree) if isinstance(n, ast.Import)]
    assert got == [False, True]


def test_the_optional_import_guard_is_recognised():
    guarded = ast.parse("try:\n    import pandas\nexcept ImportError:\n    pass\n")
    bare = ast.parse("def f():\n    import pandas\n")
    for tree, want in ((guarded, True), (bare, False)):
        parents = {c: n for n in ast.walk(tree) for c in ast.iter_child_nodes(n)}
        node = next(n for n in ast.walk(tree) if isinstance(n, ast.Import))
        assert _guarded_by_import_error(node, parents) is want
