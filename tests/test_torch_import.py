"""The port (``src/repro_torch``) and ``chip_smoke.py`` import neither JAX
nor the JAX package.

``src/sitecustomize.py`` imports jax in every process that has ``src`` on
its path, so a look at ``sys.modules`` proves nothing: an AST scan checks
every import statement, and a subprocess whose path holds nothing but a
link to the port imports every submodule with jax and repro blocked.
"""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BANNED = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_ast_scan_finds_no_jax_or_repro_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for mod, line in _imported_roots(f)
           if mod in BANNED]
    assert not bad, bad


def test_every_submodule_imports_with_jax_and_repro_blocked(tmp_path):
    (tmp_path / "repro_torch").symlink_to(PORT, target_is_directory=True)
    script = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ModuleNotFoundError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not leaked, leaked
        print("imported", len(names))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(tmp_path)
    res = subprocess.run([sys.executable, "-c", script], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    n = int(res.stdout.split()[-1])
    assert n >= 20, res.stdout
