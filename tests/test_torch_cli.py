"""The port's inference CLI (``avatar_tpu_torch/cli/infer.py``) against
the JAX package's on the CPU, on one tiny single-file checkpoint (written
by the JAX package), one embeddings file, a reference image and a folder
of pose frames: each CLI's pipeline call is captured (its ``__call__``
patched in this test) and the two must hand their pipelines the same
``GenerationParams``, embeddings, conditioning media (bit for bit) and
window layout, on the single-pass, windowed and multi-scale branches. Then
the port's ``generate`` against its pipeline called directly with
``torch.Generator().manual_seed(seed)`` and with its conditioning media
handed over already loaded, ``main`` from argv on each branch, the
branches that raise, and that ``chip_smoke.py``'s kernel phases hold
every attention shape of its CLI phases."""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import avatar_tpu.pipelines as jpipes
from avatar_tpu.cli import infer as jinfer
from avatar_tpu.models import dit as jdit
from avatar_tpu.models import vae as jvae
from avatar_tpu.pipelines import multiscale as jms
from avatar_tpu.pipelines import pipeline as jpipe
from avatar_tpu.utils import safetensors_io as jst
from avatar_tpu.utils import weight_import as jwi
from avatar_tpu_torch.cli import infer as tinfer
from avatar_tpu_torch.models import latent_upsampler as tup
from avatar_tpu_torch.pipelines import long_video as tlong
from avatar_tpu_torch.pipelines import multiscale as tms
from avatar_tpu_torch.pipelines import pipeline as tpipe
from avatar_tpu_torch.utils.safetensors_io import save_safetensors
from torch_parity import dit_numpy_params, vae_numpy_params

torch.set_num_threads(2)

CH, SIZE, POSE_FRAMES, SEED = 8, 64, 25, 7
DIT_KW = dict(num_attention_heads=2, attention_head_dim=8, in_channels=CH, out_channels=CH,
              num_layers=2, cross_attention_dim=16, caption_channels=32)
PIPELINE = {
    "precision": "float32", "sampler": "from_checkpoint", "num_inference_steps": 2,
    "guidance_scale": 3.0, "stg_scale": 1.0, "rescaling_scale": 0.7,
    "skip_block_list": [1], "stg_mode": "stg_r", "decode_timestep": 0.05,
    "decode_noise_scale": 0.025, "cfg_star_rescale": True, "overlap_frames": 9,
}


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The checkpoint, the embeddings (prompt and negative), a 64 px
    reference image, 25 pose frames, a latent upsampler and three pipeline
    yamls: single pass, windowed (window 17), multi-scale."""
    tmp = tmp_path_factory.mktemp("cli")
    dcfg = jdit.DiTConfig(**DIT_KW)
    vcfg = dataclasses.replace(jvae.demo_config(latent_channels=CH), base_channels=16,
                               decoder_base_channels=16)
    ckpt = tmp / "ckpt.safetensors"
    vtree = vae_numpy_params(vcfg)
    jwi.save_single_file_checkpoint(
        ckpt, dit_numpy_params(dcfg), dcfg, vae_state=jwi.export_vae_state(vtree, vcfg),
        vae_config=vcfg.to_dict(),
        scheduler_config={"_class_name": "RectifiedFlowScheduler", "sampler": "Uniform",
                          "shifting": "SD3", "target_shift_terminal": 0.1})
    rng = np.random.default_rng(5)
    embeds = tmp / "embeds.safetensors"
    mask = np.ones((1, 8), np.float32)
    mask[0, 6:] = 0.0
    jst.save_safetensors({
        "prompt_embeds": rng.standard_normal((1, 8, 32)).astype(np.float32),
        "prompt_attention_mask": mask,
        "negative_prompt_embeds": rng.standard_normal((1, 8, 32)).astype(np.float32),
        "negative_prompt_attention_mask": np.ones((1, 8), np.float32)}, embeds)
    ref = tmp / "ref.png"
    Image.fromarray(rng.integers(0, 255, (80, 64, 3), dtype=np.uint8)).save(ref)
    pose = tmp / "pose"
    pose.mkdir()
    for i in range(POSE_FRAMES):
        Image.fromarray(rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8)).save(
            pose / f"frame_{i:04d}.png")
    up_cfg = tup.LatentUpsamplerConfig(in_channels=CH, mid_channels=32,
                                       num_blocks_per_stage=1)
    upsampler = tmp / "upsampler.safetensors"
    save_safetensors(tup.export_latent_upsampler_state(
        tup.init_latent_upsampler(up_cfg, seed=3, device="cpu")), upsampler,
        metadata={"config": json.dumps(up_cfg.to_dict())})
    yamls = {}
    for kind, extra in (("single", {}), ("window", {"window_frames": 17}),
                        ("multiscale", {"pipeline_type": "multi-scale",
                                        "spatial_upscaler_model_path": str(upsampler)})):
        yamls[kind] = tmp / f"{kind}.yaml"
        yamls[kind].write_text(yaml.safe_dump(
            dict(PIPELINE, checkpoint_path=str(ckpt), **extra)))
    return dict(tmp=tmp, embeds=embeds, ref=ref, pose=pose, yamls=yamls)


def _config_kw(assets, kind, out):
    return dict(prompt="a talking head", output_path=str(assets["tmp"] / out),
                pipeline_config=str(assets["yamls"][kind]), seed=SEED, height=SIZE,
                width=SIZE, frame_rate=20, prompt_embeds_path=str(assets["embeds"]),
                conditioning_media_paths=[str(assets["ref"]), str(assets["pose"])])


def _capture_jax(monkeypatch):
    """Run the JAX CLI with its pipeline call recorded (and answered with
    zero frames of the right shape)."""
    seen = {}

    def fake(_, params, key, *args, **kw):
        seen.update(params=params, args=args, kw=kw)
        return jax.numpy.zeros((1, params.num_frames + 1, params.height, params.width, 3),
                               jax.numpy.uint8)

    def fake_long(pipeline, params, long, key, *args, **kw):
        seen.update(params=params, long=long, args=args, kw=kw)
        return np.zeros((1, long.num_frames, params.height, params.width, 3), np.uint8)

    monkeypatch.setattr(jpipe.LTXVideoPipeline, "__call__", fake)
    monkeypatch.setattr(jms.LTXMultiScalePipeline, "__call__", fake)
    monkeypatch.setattr(jpipes, "generate_long_video", fake_long)
    return seen


def _capture_port(monkeypatch):
    seen = {}

    def fake(_, params, generator, *args, **kw):
        seen.update(params=params, args=args, kw=kw)
        return torch.zeros((1, params.num_frames + 1, params.height, params.width, 3),
                           dtype=torch.uint8)

    def fake_long(pipeline, params, long, generator, *args, **kw):
        seen.update(params=params, long=long, args=args, kw=kw)
        return torch.zeros((1, long.num_frames, params.height, params.width, 3),
                           dtype=torch.uint8)

    monkeypatch.setattr(tpipe.LTXVideoPipeline, "__call__", fake)
    monkeypatch.setattr(tms.LTXMultiScalePipeline, "__call__", fake)
    monkeypatch.setattr(tlong, "generate_long_video", fake_long)
    return seen


def _plain(value):
    if isinstance(value, (jax.Array, np.ndarray)):
        return np.asarray(value)
    if isinstance(value, torch.Tensor):
        return value.numpy()
    if hasattr(value, "name") and hasattr(value, "value"):  # an enum member
        return value.name
    return value


@pytest.mark.parametrize("kind", ["single", "window", "multiscale"])
def test_cli_hands_its_pipeline_what_the_jax_cli_does(assets, monkeypatch, kind):
    jseen = _capture_jax(monkeypatch)
    jinfer.infer(jinfer.InferenceConfig(**_config_kw(assets, kind, f"jax_{kind}")))
    tseen = _capture_port(monkeypatch)
    tinfer.infer(tinfer.InferenceConfig(**_config_kw(assets, kind, f"port_{kind}"),
                                        device="cpu"))
    jp, tp = jseen["params"], tseen["params"]
    assert [f.name for f in dataclasses.fields(tp)] == [f.name for f in dataclasses.fields(jp)]
    for f in dataclasses.fields(jp):
        assert _plain(getattr(tp, f.name)) == _plain(getattr(jp, f.name)), f.name
    assert tp.num_frames == POSE_FRAMES - 1 and tp.skip_layer_strategy.name == "Residual"
    # the embeddings: positional on the single and multi-scale call, the
    # negative ones by keyword into generate_long_video
    names = ("negative_prompt_embeds", "negative_prompt_attention_mask")
    jemb = list(jseen["args"]) + [jseen["kw"].get(n) for n in names if n in jseen["kw"]]
    temb = list(tseen["args"]) + [tseen["kw"].get(n) for n in names if n in tseen["kw"]]
    assert len(jemb) == len(temb) == 4
    for a, b in zip(temb, jemb):
        np.testing.assert_array_equal(_plain(a), _plain(b))
    for name in ("ref_image", "pose_frames"):
        got, want = _plain(tseen["kw"][name]), _plain(jseen["kw"][name])
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert _plain(tseen["kw"]["pose_frames"]).shape == (1, POSE_FRAMES, SIZE, SIZE, 3)
    if kind == "window":
        assert dataclasses.asdict(tseen["long"]) == dataclasses.asdict(jseen["long"])
        assert tseen["long"].window_frames == 17 and tseen["long"].overlap_frames == 9
    else:
        assert "long" not in tseen and tseen["kw"]["media_items"] is None
        assert jseen["kw"]["media_items"] is None
        assert tseen["kw"]["output_type"] == jseen["kw"]["output_type"] == "uint8"
    assert [p.name for p in (assets["tmp"] / f"port_{kind}").iterdir()] == [
        p.name for p in (assets["tmp"] / f"jax_{kind}").iterdir()]


def test_generate_equals_the_pipeline_called_directly(assets):
    pcfg = tinfer.load_pipeline_config(str(assets["yamls"]["single"]))
    config = tinfer.InferenceConfig(**_config_kw(assets, "single", "direct"), device="cpu")
    video = tinfer.generate(config, pcfg)
    assert video.dtype == np.uint8 and video.shape == (1, POSE_FRAMES, SIZE, SIZE, 3)

    from avatar_tpu_torch.data.media import load_media_file

    pipe = tinfer.load_pipeline(pcfg, device="cpu")
    emb = jst.load_safetensors(str(assets["embeds"]))[0]
    media = [torch.from_numpy(load_media_file(p, SIZE, SIZE, (0, 0, 0, 0)))
             for p in (assets["ref"], assets["pose"])]
    params = tpipe.GenerationParams(
        height=SIZE, width=SIZE, num_frames=POSE_FRAMES - 1, frame_rate=20,
        num_inference_steps=2, guidance_scale=3.0, stg_scale=1.0, rescaling_scale=0.7,
        skip_block_list=[1], skip_layer_strategy=tpipe.SkipLayerStrategy.Residual,
        decode_timestep=0.05, decode_noise_scale=0.025, cfg_star_rescale=True)
    direct = pipe(params, torch.Generator().manual_seed(SEED),
                  *(torch.from_numpy(emb[k]) for k in (
                      "prompt_embeds", "prompt_attention_mask", "negative_prompt_embeds",
                      "negative_prompt_attention_mask")),
                  ref_image=media[0], pose_frames=media[1], output_type="uint8")
    np.testing.assert_array_equal(video, direct.numpy())


def test_generate_takes_loaded_conditioning(assets):
    """The reference image and pose frames handed over already loaded give
    the frames of the paths they were loaded from, the frame count following
    the pose frames; paths and loaded media together are refused."""
    from avatar_tpu_torch.data.media import load_media_file

    pcfg = tinfer.load_pipeline_config(str(assets["yamls"]["single"]))
    pipe = tinfer.load_pipeline(pcfg, device="cpu")
    kw = _config_kw(assets, "single", "loaded")
    from_paths = tinfer.generate(tinfer.InferenceConfig(**kw, device="cpu"), pcfg, pipe)
    media = [load_media_file(p, SIZE, SIZE, (0, 0, 0, 0))
             for p in (assets["ref"], assets["pose"])]
    config = tinfer.InferenceConfig(**dict(kw, conditioning_media_paths=None), device="cpu")
    loaded = tinfer.generate(config, pcfg, pipe, conditioning=media)
    assert config.num_frames == POSE_FRAMES
    np.testing.assert_array_equal(loaded, from_paths)
    with pytest.raises(ValueError, match="not both"):
        tinfer.generate(tinfer.InferenceConfig(**kw, device="cpu"), pcfg, pipe,
                        conditioning=media)


@pytest.mark.parametrize("kind,frames", [("single", 9), ("window", 25), ("multiscale", 9)])
def test_main_from_argv(assets, monkeypatch, kind, frames):
    """Each branch end to end from the command line on the CPU (2 steps):
    one mp4 of the asked frames, named as the JAX CLI names it."""
    out = assets["tmp"] / f"main_{kind}"
    argv = ["infer", "--pipeline_config", str(assets["yamls"][kind]), "--seed", str(SEED),
            "--height", str(SIZE), "--width", str(SIZE), "--num_frames", str(frames),
            "--prompt_embeds_path", str(assets["embeds"]), "--output_path", str(out),
            "--device", "cpu"]
    if kind == "window":
        argv += ["--conditioning_media_paths", str(assets["ref"]), str(assets["pose"])]
    monkeypatch.setattr(sys, "argv", argv)
    assert tinfer.main() == out
    (video,) = out.iterdir()
    assert video.name == f"video_output_0_{SEED}_{SIZE}x{SIZE}x{frames}.mp4"
    from avatar_tpu_torch.data.media import read_video_frames

    got = np.stack(list(read_video_frames(video)))
    assert got.shape == (frames, SIZE, SIZE, 3) and got.std() > 0


def test_one_conditioning_path_runs_as_in_jax(assets, monkeypatch):
    """A reference image without pose frames: both CLIs run, the image
    encoded and the avatar lerp left out (the port's pipeline raised
    before)."""
    kw = dict(_config_kw(assets, "single", "one"), conditioning_media_paths=[
        str(assets["ref"])], num_frames=9)
    pcfg = tinfer.load_pipeline_config(str(assets["yamls"]["single"]))
    pipe = tinfer.load_pipeline(pcfg, device="cpu")
    with_ref = tinfer.generate(tinfer.InferenceConfig(**kw, device="cpu"), pcfg, pipe)
    without = tinfer.generate(tinfer.InferenceConfig(
        **dict(kw, conditioning_media_paths=None), device="cpu"), pcfg, pipe)
    assert with_ref.shape == (1, 9, SIZE, SIZE, 3)
    # the reference's encoder draw comes first from the generator, so the
    # noise moves: the frames differ, but both runs complete
    assert with_ref.std() > 0 and without.std() > 0
    jseen = _capture_jax(monkeypatch)
    jinfer.infer(jinfer.InferenceConfig(**_config_kw(assets, "single", "jax_one") | dict(
        conditioning_media_paths=[str(assets["ref"])], num_frames=9)))
    assert jseen["kw"]["pose_frames"] is None and jseen["kw"]["ref_image"] is not None


def _int8_convs(tree) -> list:
    if isinstance(tree, dict):
        k = tree.get("kernel_q8")
        return [k] * (getattr(k, "ndim", 0) == 5) + _int8_convs(list(tree.values()))
    if isinstance(tree, list):
        return [c for v in tree for c in _int8_convs(v)]
    return []


def test_unported_and_refused_branches_raise(assets, tmp_path, monkeypatch):
    # --text is ported (the pose path; tests/test_torch_faceformer.py runs
    # it): the rendered pose directory joins the reference image
    from avatar_tpu_torch.pipelines import pose_frames

    monkeypatch.setattr(pose_frames, "detect_face_bbox", lambda image: (0.2, 0.2, 0.8, 0.8))
    monkeypatch.setattr(pose_frames, "generate_faceformer_frames",
                        lambda text, output_dir, **kw: Path(output_dir))
    seen = {}
    monkeypatch.setattr(tinfer, "infer", lambda config: seen.setdefault("config", config))
    tinfer.main(["--text", "hello", "--conditioning_media_paths", str(assets["ref"]),
                 "--output_path", str(tmp_path / "o"), "--device", "cpu"])
    assert seen["config"].conditioning_media_paths == [
        str(assets["ref"]), str(tmp_path / "o" / "pose_frames")]
    monkeypatch.undo()
    # quantization_vae is ported: it reaches the VAE instead of raising
    pcfg = dict(tinfer.load_pipeline_config(str(assets["yamls"]["single"])),
                quantization_vae="w8a8")
    assert _int8_convs(tinfer.load_pipeline(pcfg, device="cpu").vae_params)
    both = tmp_path / "both.yaml"
    both.write_text(yaml.safe_dump(dict(
        tinfer.load_pipeline_config(str(assets["yamls"]["multiscale"])), window_frames=17)))
    kw = dict(_config_kw(assets, "single", "both"), pipeline_config=str(both))
    with pytest.raises(ValueError) as jerr:
        jinfer.infer(jinfer.InferenceConfig(**kw))
    with pytest.raises(ValueError) as terr:
        tinfer.infer(tinfer.InferenceConfig(**kw, device="cpu"))
    assert str(terr.value) == str(jerr.value)
    assert "multi-scale" in str(terr.value)


@pytest.mark.parametrize("quantize", [None, "w8"])
def test_t5_prompts_match_jax(tmp_path, monkeypatch, quantize):
    """Without ``prompt_embeds_path`` both CLIs T5-encode the prompt and the
    negative prompt: a tiny T5 directory (the HF layout), the tokenizer
    stubbed (its files are not in the repository)."""
    import transformers

    from avatar_tpu.models import t5 as jt5
    from test_torch_t5 import CFG, _hf_state, _StubTokenizer

    jcfg = jt5.T5Config(**CFG, feed_forward_proj="gated-gelu")
    tree = jax.tree.map(np.asarray, jt5.init_t5_encoder(jax.random.PRNGKey(1), jcfg))
    enc = tmp_path / "text_encoder"
    enc.mkdir()
    save_safetensors(_hf_state(tree), enc / "model.safetensors")
    (enc / "config.json").write_text(json.dumps({**CFG, "feed_forward_proj": "gated-gelu"}))
    monkeypatch.setattr(transformers.T5TokenizerFast, "from_pretrained",
                        lambda *a, **k: _StubTokenizer())
    pcfg = {"text_encoder_model_name_or_path": str(tmp_path),
            "quantization_text_encoder": quantize}
    kw = dict(prompt="a woman talks to the camera", negative_prompt="blurry, jittery")
    want = jinfer._encode_prompts(jinfer.InferenceConfig(**kw), pcfg)
    got = tinfer._encode_prompts(tinfer.InferenceConfig(**kw, device="cpu"), pcfg, "cpu")
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=2e-5)


def test_chip_smoke_checks_every_cli_attention_shape():
    """The card smoke test's kernel phases hold each attention call of its
    CLI phases against the plain version: each grid's self- and
    cross-attention is listed once, under the counter its launches are
    expected on, and nowhere else."""
    import math

    import chip_smoke as cs

    counters = {name for grid in cs.CLI_GRIDS.values()
                for name, _ in cs.dit_routes(math.prod(grid), cs.CAPTION)}
    listed = {c: cs.cli_shapes(c) for c in counters | {"flash_online"}}
    assert sum(len(v) for v in listed.values()) == 2 * len(cs.CLI_GRIDS)
    for grid in cs.CLI_GRIDS.values():
        n = math.prod(grid)
        (self_name, _), (cross_name, _) = cs.dit_routes(n, cs.CAPTION)
        assert (n, n, grid) in [s[1:] for s in listed[self_name]]
        assert (n, cs.CAPTION, grid) in [s[1:] for s in listed[cross_name]]
        counts = cs.dit_route_counts(n, cs.CAPTION, 3)
        assert sum(counts[name] for name in {self_name, cross_name}) == 6
    # the multi-scale second pass is 1536 tokens: past A's cap, so C
    assert [s[1] for s in listed["flash_bounded"]] == [1536]
