"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is the port, ``repro`` is not),
and the plain reference imports nothing of the port."""
import ast

import pytest

from cardbench import manifest

FILES = sorted(manifest.HERE.rglob("*.py"))


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(manifest.HERE)))
def test_no_jax_anywhere(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((manifest.HERE / "reference")
                                        .glob("*.py")), ids=lambda p: p.name)
def test_reference_stands_alone(path):
    assert imported(path) <= {"__future__", "math", "torch"}
