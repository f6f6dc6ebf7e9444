"""No module of the benchmark loads JAX or the JAX package; the reference
loads nothing of the program either.  Top-level names are compared whole:
swiftwatcher_tpu_torch begins with swiftwatcher_tpu."""

import ast
import subprocess
import sys

import pytest

from swtbench.spec import HERE, ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "swiftwatcher_tpu"}
PROGRAM = "swiftwatcher_tpu_torch"
SOURCES = sorted(HERE.rglob("*.py"))


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_the_jax_side(path):
    assert not _top_level_imports(path) & JAX_SIDE


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")) + [HERE / "traffic.py"]:
        assert PROGRAM not in _top_level_imports(path), path
    # and nothing it loads does: import it with the program and the JAX side
    # made unimportable
    blocked = sorted(JAX_SIDE | {PROGRAM})
    code = (
        "import sys, importlib.abc\n"
        f"BLOCKED = {blocked!r}\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import swtbench.reference, swtbench.compare, swtbench.traffic\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
