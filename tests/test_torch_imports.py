"""Import hygiene of the PyTorch port: no module of ``avatar_tpu_torch``
and not ``chip_smoke.py`` imports JAX or the JAX package, every public
entry point runs on the card unless the caller asks for the CPU, and
``chip_smoke.py``'s copy of the shipped inference yaml is the yaml."""

import ast
import inspect
from pathlib import Path

import pytest
import yaml

from avatar_tpu_torch.cli import infer, preprocess
from avatar_tpu_torch.cli import train as train_cli
from avatar_tpu_torch.models import (dit, faceformer, latent_upsampler, vae,
                                     video_autoencoder, wav2vec2)
from avatar_tpu_torch.ops import rope
from avatar_tpu_torch.parallel import distributed as parallel_distributed
from avatar_tpu_torch.pipelines import pipeline, pose_frames
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


# the modules ported with training part 1 and the pose path
TRAIN_POSE_SLICE = ("train/decoder.py", "train/validation.py", "models/wav2vec2.py",
                    "models/faceformer.py", "pipelines/pose_frames.py", "cli/train.py")


@pytest.mark.parametrize("rel", TRAIN_POSE_SLICE)
def test_train_pose_slice_modules_are_checked(rel):
    path = ROOT / "avatar_tpu_torch" / rel
    assert path in PORT_FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]


# the modules ported with the preprocessing CLI and the rest of the
# single-device modules
PREPROCESS_SLICE = ("cli/preprocess.py", "cli/scrape.py", "utils/profiling.py",
                    "utils/prompt_enhance.py", "models/video_autoencoder.py",
                    "ops/dual_conv3d.py", "ops/causal_conv3d.py", "utils/weight_import.py")


@pytest.mark.parametrize("rel", PREPROCESS_SLICE)
def test_preprocess_slice_modules_are_checked(rel):
    path = ROOT / "avatar_tpu_torch" / rel
    assert path in PORT_FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]


# the multi-device layer
PARALLEL_SLICE = ("parallel/__init__.py", "parallel/collectives.py",
                  "parallel/distributed.py", "parallel/mesh.py", "parallel/pipeline.py",
                  "parallel/sequence.py")


@pytest.mark.parametrize("rel", PARALLEL_SLICE)
def test_parallel_slice_modules_are_checked(rel):
    path = ROOT / "avatar_tpu_torch" / rel
    assert path in PORT_FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]


def test_every_jax_module_has_a_counterpart():
    """Every module of the JAX package has a counterpart of the same name
    in the port, and the port's ``parallel`` exports the JAX package's
    public names."""
    import avatar_tpu.parallel as jparallel

    import avatar_tpu_torch.parallel as tparallel

    jax_pkg = ROOT / "avatar_tpu"
    missing = sorted(str(p.relative_to(jax_pkg)) for p in jax_pkg.rglob("*.py")
                     if not (ROOT / "avatar_tpu_torch" / p.relative_to(jax_pkg)).exists())
    assert missing == []
    assert not set(jparallel.__all__) - set(tparallel.__all__)


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
    faceformer.load_faceformer, faceformer.import_faceformer_state,
    wav2vec2.import_wav2vec2_state, pose_frames.generate_faceformer_frames,
    weight_import.wav2vec2_params_from_numpy, weight_import.faceformer_params_from_numpy,
    train_cli.decoder_train_loop, train_cli.encode_train_prompt, train_cli.train_loop,
    preprocess.VAEEncoder.__init__, preprocess.VAEEncoder.from_params,
    weight_import.load_checkpoint, weight_import.video_autoencoder_params_from_numpy,
    video_autoencoder.init_video_autoencoder,
    video_autoencoder.import_video_autoencoder_state, parallel_distributed.initialize,
], ids=lambda f: f.__qualname__)
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
