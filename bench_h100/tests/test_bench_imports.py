"""Neither the harness nor the reference imports JAX, flax or the JAX
package (top-level names compared whole), and the reference imports nothing
of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "hept_tpu"}


def imported_top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(p for p in ROOT.rglob("*.py") if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_by_whole_name(path):
    assert not imported_top_names(path) & FORBIDDEN


def test_whole_names_tell_the_port_from_the_jax_package():
    from bench_h100 import harness

    assert harness.forbidden_modules(["hept_tpu_torch", "hept_tpu_torch.ops", "numpy"]) == []
    assert harness.forbidden_modules(["hept_tpu.core", "jax._src", "flax", "jaxlib.x"]) == \
        ["flax", "hept_tpu", "jax", "jaxlib"]


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "hept_tpu_torch" not in imported_top_names(path)


def test_reference_loads_alone():
    code = ("import sys; sys.path.insert(0, %r); "
            "import bench_h100.reference.tracking_hept_acc, bench_h100.reference.tracking_hept; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'hept_tpu', 'hept_tpu_torch'}))") % str(ROOT.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.strip()
    assert out == "[]"
