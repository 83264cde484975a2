"""The port's layering, read from its source by AST: no model is built.

- ops/_build.TABLE has exactly one entry for every native source of csrc/,
  and every entry has its source; every counting wrapper of ops/ is in the
  table, and the launch reports (bench, parallel/ranks) take their wrappers
  from ``launch_counters``; no module but ops/_build.py loads a library;
- every arch module declares the kernels it launches, from the table; no
  arch module imports a private name of another, and the only imports
  between arch modules are those of an arch built on another (RSH on uPIT,
  Conv-TasNet's separator on TCN's stack);
- ops/, dsp/ and utils/ import nothing of eval/, train/, cli/ or models/.
"""

import ast
from pathlib import Path

import pytest
import torch

from speech_separation_tpu_torch.ops import _build

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

PKG = Path(__file__).resolve().parents[1] / "speech_separation_tpu_torch"
MODELS = PKG / "models"
# (importer, imported) arch pairs: an arch built on another's public names
ARCH_BASES = {("rsh", "upit"), ("convtasnet", "tcn")}
LOWER = ("ops", "dsp", "utils")
UPPER = {"eval", "train", "cli", "models"}
# the one module of a lower layer that reaches up: a whole-program tool
# (checkpoints in, the trainer's files out), which ROADMAP F.6 moves to cli/
LOWER_EXCEPTIONS = {"utils/import_reference.py"}


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def _imports(path: Path):
    """(package-relative module, imported names) of every import in a file,
    nested ones included: ``from ..ops import mxu`` in models/x.py reads as
    ("ops", ["mxu"]), ``from . import tcn`` as ("models", ["tcn"])."""
    parts = path.relative_to(PKG).parent.parts
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.ImportFrom):
            if node.level:
                base = list(parts[:len(parts) - node.level + 1])
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module.removeprefix("speech_separation_tpu_torch").lstrip(".")
            yield mod, [a.name for a in node.names]
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith("speech_separation_tpu_torch."):
                    yield a.name.removeprefix("speech_separation_tpu_torch."), []


def _module_names(path: Path) -> dict:
    """Module-level assignments of a file: {name: value node}."""
    return {t.id: node.value for node in _tree(path).body if isinstance(node, ast.Assign)
            for t in node.targets if isinstance(t, ast.Name)}


ARCHS = sorted(p.stem for p in MODELS.glob("*.py") if "NAME" in _module_names(p))


def test_the_archs_are_found():
    assert ARCHS == ["convtasnet", "dprnn", "rsh", "sepformer", "tcn", "upit"]


# ------------------------------------------------------------ native kernels

def test_every_native_source_has_one_table_entry():
    sources = sorted(p.stem for p in (PKG / "csrc").iterdir() if p.suffix in (".cu", ".cpp"))
    assert sorted(_build.TABLE) == sources
    for name, src in _build.TABLE.items():
        assert (PKG / "csrc" / f"{name}.{'cpp' if src.host else 'cu'}").is_file(), name
    assert sorted(_build.SOURCES) == [n for n in sources if not _build.TABLE[n].host]


def test_launch_counters_cover_every_counting_wrapper():
    named = [fn for src in _build.TABLE.values() for _, fn in src.wrappers]
    assert [f.__name__ for f in _build.launch_counters()] == named
    counting = []
    for path in sorted((PKG / "ops").glob("*.py")):
        for node in _tree(path).body:
            if isinstance(node, ast.Assign):
                counting += [(path.stem, t.value.id) for t in node.targets
                             if isinstance(t, ast.Attribute) and t.attr == "launches"]
    assert sorted(counting) == sorted(w for src in _build.TABLE.values() for w in src.wrappers)


@pytest.mark.parametrize("reporter", ["bench.py", "parallel/ranks.py"])
def test_launch_reports_take_the_table_s_wrappers(reporter):
    calls = {n.func.id for n in ast.walk(_tree(PKG / reporter))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    assert "launch_counters" in calls


def test_only_the_seam_loads_a_library():
    loaders = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
               for n in ast.walk(_tree(p))
               if isinstance(n, ast.Attribute) and n.attr in ("CDLL", "cdll", "LoadLibrary")}
    assert loaders == {"ops/_build.py"}


@pytest.mark.parametrize("arch", ARCHS)
def test_each_arch_declares_its_kernels_from_the_table(arch):
    kernels = ast.literal_eval(_module_names(MODELS / f"{arch}.py")["KERNELS"])
    assert set(kernels) <= set(_build.TABLE) and len(set(kernels)) == len(kernels)


# -------------------------------------------------------------------- models

@pytest.mark.parametrize("arch", ARCHS)
def test_arch_modules_are_not_each_other_s_libraries(arch):
    path = MODELS / f"{arch}.py"
    for mod, names in _imports(path):
        if mod == "models":                   # from . import <module>
            pairs = [(n, None) for n in names if n in ARCHS]
        elif mod.startswith("models.") and mod.split(".")[1] in ARCHS:
            pairs = [(mod.split(".")[1], n) for n in names]
        else:
            continue
        for other, name in pairs:
            assert (arch, other) in ARCH_BASES, f"{arch} imports {other}"
            assert name is None or not name.startswith("_"), f"{arch} imports {other}.{name}"
    assert "noqa: F401" not in path.read_text()


# --------------------------------------------------------------- lower layers

@pytest.mark.parametrize("layer", LOWER)
def test_lower_layers_do_not_import_upper_ones(layer):
    reach = []
    for path in sorted((PKG / layer).rglob("*.py")):
        rel = str(path.relative_to(PKG))
        if rel in LOWER_EXCEPTIONS:
            continue
        reach += [(rel, mod) for mod, _ in _imports(path) if mod.split(".")[0] in UPPER]
    assert reach == []
