"""Nothing of the benchmark imports JAX or the JAX package, and its
reference imports nothing of the program."""

import ast
from pathlib import Path

from benchmark import run

BENCH = Path(__file__).resolve().parent.parent


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        found = top_level_imports(path) & {"jax", "jaxlib", "flax", "avatar_tpu"}
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert "avatar_tpu_torch" not in top_level_imports(path), path
        assert "avatar_tpu_torch" not in path.read_text(), path


def test_the_run_names_what_it_must_not_hold_by_whole_top_level_names():
    assert run.forbidden_modules({"avatar_tpu_torch": 1, "avatar_tpu_torch.models": 1}) == []
    assert run.forbidden_modules({"avatar_tpu.models": 1, "jaxlib": 1}) == ["avatar_tpu", "jaxlib"]
    assert run.forbidden_modules({"jax_utils": 1, "flaxen": 1}) == []
