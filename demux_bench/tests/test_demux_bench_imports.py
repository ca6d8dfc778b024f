"""Nothing under demux_bench imports JAX or the JAX package, and neither
the harness nor its reference imports the program (its tests' fault
wrapper drives the program and is the one exception). Top-level module
names are compared whole: pheniqs_tpu_torch begins with pheniqs_tpu."""

import ast

import pytest

from demux_bench.cells import HERE

JAX = {"jax", "jaxlib", "flax", "pheniqs_tpu"}


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize("path", [p for p in SOURCES if "tests" not in p.parts],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_harness_does_not_import_the_program(path):
    assert "pheniqs_tpu_torch" not in imported(path)
