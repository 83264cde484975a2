"""Nothing under port_bench/ imports JAX or the JAX package, and its plain
references import nothing of the port: each import's top-level name,
before the first dot, compared as a whole name."""

import ast

import pytest

from port_bench.harness import core

MODULES = sorted(core.BENCH_DIR.rglob("*.py"))


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(core.BENCH_DIR)))
def test_no_jax_and_no_port_in_the_references(path):
    names = top_level_imports(path)
    assert not names & set(core.FORBIDDEN), names & set(core.FORBIDDEN)
    if path.parent.name == "reference":
        assert "speech_separation_tpu_torch" not in names


def test_the_comparison_is_by_whole_names():
    import sys
    before = set(sys.modules)
    sys.modules["speech_separation_tpu_torch_probe"] = sys
    try:
        assert "speech_separation_tpu_torch_probe" not in core.forbidden_modules()
        sys.modules["jax.probe"] = sys
        assert "jax.probe" in core.forbidden_modules()
    finally:
        for k in set(sys.modules) - before:
            del sys.modules[k]
