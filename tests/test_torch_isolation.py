"""The port stands alone: it imports neither JAX nor the JAX package.

Two checks: importing every module of hbird_tpu_torch in a fresh
interpreter leaves `jax` and `hbird_tpu` out of `sys.modules`; and a scan
of the port's sources, of chip_smoke.py and of the GPU test file (run
where JAX may be absent) finds no import of either (module paths only —
comments may name the JAX files a module replaces).
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "hbird_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import hbird_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hbird_tpu_torch.__path__, "hbird_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import hbird_tpu_torch.hbird_eval
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
                or m == "hbird_tpu" or m.startswith("hbird_tpu."))
print(len(names), leaked)
sys.exit(1 if leaked or len(names) < 20 else 0)
"""


def test_importing_every_module_leaves_jax_out():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sources():
    files = sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py",
        ROOT / "tests" / "test_torch_knn_cuda.py",
        ROOT / "tests" / "test_torch_ivf_cuda.py",
        ROOT / "tests" / "test_torch_flash_cuda.py",
        ROOT / "tests" / "test_torch_bank_cuda.py",
        ROOT / "tests" / "test_torch_parallel_cuda.py",
    ]
    assert len(files) > 20
    return files


def _is_forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "hbird_tpu")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_hbird_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", "")) in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            names = [str(node.args[0].value)]
        else:
            continue
        bad = [n for n in names if _is_forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"
    # dotted module references in strings or comments, e.g. "hbird_tpu.ops"
    text = path.read_text()
    for token in ("hbird_tpu.", "import jax", "from jax"):
        for line_no, line in enumerate(text.splitlines(), 1):
            assert token not in line.replace("hbird_tpu_torch.", ""), f"{path}:{line_no}: {line}"
