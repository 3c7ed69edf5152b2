"""Import hygiene of the PyTorch port: no module of ``avatar_tpu_torch``
and not ``chip_smoke.py`` imports JAX or the JAX package, and every public
entry point runs on the card unless the caller asks for the CPU."""

import ast
import inspect
from pathlib import Path

import pytest

from avatar_tpu_torch.models import dit, vae
from avatar_tpu_torch.ops import rope
from avatar_tpu_torch.pipelines import pipeline
from avatar_tpu_torch.utils import weight_import

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "avatar_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "avatar_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists()
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule_spares_the_port_package():
    assert _forbidden("avatar_tpu.models.dit") and _forbidden("jax.numpy")
    assert not _forbidden("avatar_tpu_torch.models.dit")


@pytest.mark.parametrize("fn", [
    dit.init_dit, vae.init_vae, weight_import.dit_params_from_numpy,
    weight_import.vae_params_from_numpy, pipeline.LTXVideoPipeline.__init__,
    rope.get_latent_coords,
], ids=lambda f: f.__qualname__)
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
