"""Import hygiene of the PyTorch port: no module of ``avatar_tpu_torch``
and not ``chip_smoke.py`` imports JAX or the JAX package, every public
entry point runs on the card unless the caller asks for the CPU, and
``chip_smoke.py``'s copy of the shipped inference yaml is the yaml."""

import ast
import inspect
from pathlib import Path

import pytest
import yaml

from avatar_tpu_torch.cli import infer
from avatar_tpu_torch.models import dit, latent_upsampler, vae
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


# the modules ported with the inference CLI, each one a file the rule reads
CLI_SLICE = ("cli/infer.py", "data/media.py", "native/__init__.py",
             "pipelines/long_video.py", "pipelines/multiscale.py",
             "models/latent_upsampler.py", "models/vae_tiling.py")


@pytest.mark.parametrize("rel", CLI_SLICE)
def test_cli_slice_modules_are_checked(rel):
    path = ROOT / "avatar_tpu_torch" / rel
    assert path in PORT_FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]


def test_chip_smoke_pipeline_config_is_the_shipped_yaml():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    (node,) = [n.value for n in tree.body if isinstance(n, ast.Assign)
               and any(getattr(t, "id", None) == "INFERENCE_AVATARS_YAML" for t in n.targets)]
    shipped = yaml.safe_load((ROOT / "configs" / "inference-avatars.yaml").read_text())
    assert ast.literal_eval(node) == shipped


def test_forbidden_rule_spares_the_port_package():
    assert _forbidden("avatar_tpu.models.dit") and _forbidden("jax.numpy")
    assert not _forbidden("avatar_tpu_torch.models.dit")


@pytest.mark.parametrize("fn", [
    dit.init_dit, vae.init_vae, weight_import.dit_params_from_numpy,
    weight_import.vae_params_from_numpy, pipeline.LTXVideoPipeline.__init__,
    rope.get_latent_coords, weight_import.import_vae_state,
    weight_import.latent_upsampler_params_from_numpy,
    latent_upsampler.init_latent_upsampler, latent_upsampler.load_latent_upsampler,
    infer.create_ltx_video_pipeline, infer.load_pipeline, infer.InferenceConfig,
], ids=lambda f: f.__qualname__)
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
