"""Inference CLI (port of ``avatar_tpu/cli/infer.py``): prompt, reference
image and pose frames in, a talking-avatar video out.

    python -m avatar_tpu_torch.cli.infer --prompt_embeds_path embeds.safetensors \\
        --conditioning_media_paths ref.png pose_frames_dir \\
        --pipeline_config configs/inference-avatars.yaml [--window_frames 97] \\
        [--device cpu]

The pipeline yaml names one single-file checkpoint (transformer and VAE,
or a transformer-only export with ``vae_checkpoint_path``), and, with
``pipeline_type: multi-scale``, the latent upsampler
(``spatial_upscaler_model_path``). :func:`generate` runs the pipeline from
an already parsed config and returns the cropped uint8 frames;
:func:`write_outputs` writes them (PIL / cv2); :func:`infer` does both.
``quantization_vae`` (any true value, e.g. "w8a8") builds the pipeline
with the W8A8 VAE. ``pipeline_type: wan-i2v`` runs Wan2.1 image-to-video
instead (:func:`load_wan_pipeline`, ``pipelines/wan_i2v.py``): the
reference image is the first conditioning media path, and the
``prompt_embeds_path`` safetensors holds the umT5-XXL caption embeddings
and the image's CLIP tokens (``clip_embeds``). ``--text`` with a reference image renders the pose
frames itself (``pipelines/pose_frames.py``: face detection, Coqui TTS,
FaceFormer on the card, landmark frames; ``--faceformer_checkpoint`` and
``--flame_template`` name its files).
"""

from __future__ import annotations

import argparse
import random
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch


@dataclass
class InferenceConfig:
    """The CLI's flags (the JAX package's, plus ``device``)."""

    prompt: str = ""
    text: str = ""  # text to pronounce (drives TTS + FaceFormer)
    output_path: Optional[str] = None
    pipeline_config: str = "configs/inference-avatars.yaml"
    seed: int = 171198
    height: int = 192
    width: int = 320
    num_frames: int = 121
    frame_rate: int = 20
    negative_prompt: str = "worst quality, inconsistent motion, blurry, jittery, distorted"
    input_media_path: Optional[str] = None
    image_cond_noise_scale: float = 0.0
    conditioning_media_paths: Optional[List[str]] = None
    conditioning_strengths: Optional[List[float]] = None
    faceformer_checkpoint: str = "preprocessing/FaceFormer/vocaset.pth"
    flame_template: str = "preprocessing/FLAME_template.npy"
    # precomputed prompt embeddings (where the T5 weights are not at hand)
    prompt_embeds_path: Optional[str] = None
    # windowed long video (pipelines/long_video.py) when window_frames > 0
    # and num_frames exceeds it; 0 takes the pipeline yaml's value
    # (overlap default 9)
    window_frames: int = 0
    overlap_frames: int = 0
    device: str = "cuda"


def load_pipeline_config(pipeline_config: str) -> dict:
    """The pipeline yaml, at its path or relative to the repository."""
    import yaml

    path = Path(pipeline_config)
    if not path.is_file():
        alt = Path(__file__).parent.parent.parent / pipeline_config
        if not alt.is_file():
            raise ValueError(f"Pipeline config file {pipeline_config} does not exist")
        path = alt
    with open(path) as f:
        return yaml.safe_load(f)


def seed_everything(seed: int):
    random.seed(seed)
    np.random.seed(seed)


def create_ltx_video_pipeline(
    ckpt_path: str,
    precision: str = "bfloat16",
    sampler: Optional[str] = None,
    attention_impl: str = "auto",
    vae_ckpt_path: Optional[str] = None,
    quantize: Optional[str] = None,
    quantize_vae: Optional[str] = None,
    scan_blocks: bool = False,
    device="cuda",
):
    """VAE, transformer and schedule from one single-file checkpoint; a
    transformer-only export takes its VAE from ``vae_ckpt_path``."""
    from avatar_tpu_torch.diffusion.rf import RectifiedFlowSchedule
    from avatar_tpu_torch.models.dit import DiTConfig
    from avatar_tpu_torch.models.vae import VAEConfig
    from avatar_tpu_torch.pipelines.pipeline import LTXVideoPipeline
    from avatar_tpu_torch.utils.weight_import import (
        import_transformer_state,
        import_vae_state,
        load_single_file_checkpoint,
    )

    dtype = torch.bfloat16 if precision in ("bfloat16", "bf16") else None
    configs, t_state, v_state = load_single_file_checkpoint(ckpt_path)
    dit_cfg = DiTConfig.from_dict(configs["transformer"])
    dit_params = import_transformer_state(t_state, dit_cfg, device=device, dtype=dtype)
    del t_state
    if not v_state and vae_ckpt_path:
        v_configs, _, v_state = load_single_file_checkpoint(vae_ckpt_path)
        vae_config_dict = v_configs.get("vae", configs.get("vae"))
    else:
        vae_config_dict = configs.get("vae")
    if not v_state:
        raise ValueError(f"{ckpt_path} has no VAE weights; set vae_checkpoint_path in "
                         "the pipeline config to the base checkpoint.")
    vae_cfg = VAEConfig.from_dict(vae_config_dict)
    vae_params = import_vae_state(v_state, vae_cfg, device=device, dtype=dtype)

    if sampler == "from_checkpoint" or sampler is None:
        schedule = RectifiedFlowSchedule.from_config(configs.get("scheduler") or {})
    else:
        schedule = RectifiedFlowSchedule.create(sampler={
            "uniform": "Uniform", "linear-quadratic": "LinearQuadratic"}[sampler.lower()])
    return LTXVideoPipeline(
        dit_cfg, dit_params, vae_cfg, vae_params, schedule=schedule,
        attention_impl=attention_impl, quantize_weights=quantize or False,
        quantize_vae=quantize_vae or False, scan_blocks=scan_blocks, device=device)


def _load_state(path: str) -> dict:
    """A state dict from a safetensors file, a directory of safetensors
    shards, or a PyTorch pickle (``.pth``, tensors only)."""
    from avatar_tpu_torch.utils.safetensors_io import load_safetensors

    path = Path(path)
    if path.is_dir():
        state = {}
        for shard in sorted(path.glob("*.safetensors")):
            state.update(load_safetensors(shard)[0])
        return state
    if path.suffix == ".safetensors":
        return load_safetensors(path)[0]
    return torch.load(path, map_location="cpu", weights_only=True)


def load_wan_pipeline(pipeline_config: dict, device="cuda"):
    """The Wan2.1 I2V pipeline of a ``pipeline_type: wan-i2v`` yaml: the DiT's
    published state dict at ``checkpoint_path`` (a file or a directory of
    shards) with its ``config.json`` at ``config_path`` (the published 480P
    model's without one), the VAE's at ``vae_checkpoint_path``, with the
    latent statistics of the yaml's ``vae`` group (``latents_mean``,
    ``latents_std``) or else the published VAE's (a ``vae`` group of other
    than 16 latent channels without its own raises)."""
    import json

    from avatar_tpu_torch.models.wan import WanConfig
    from avatar_tpu_torch.models.wan_vae import WanVAEConfig
    from avatar_tpu_torch.pipelines.wan_i2v import WanI2VPipeline
    from avatar_tpu_torch.utils.weight_import import wan_params_from_state_dict

    dtype = torch.float32 if pipeline_config.get("precision") == "float32" else torch.bfloat16
    cfg = WanConfig()
    if pipeline_config.get("config_path"):
        cfg = WanConfig.from_dict(json.loads(Path(pipeline_config["config_path"]).read_text()))
    vcfg = (WanVAEConfig.from_dict(pipeline_config["vae"]) if pipeline_config.get("vae")
            else WanVAEConfig()).published_stats()
    dit = wan_params_from_state_dict(_load_state(pipeline_config["checkpoint_path"]),
                                     device=device, dtype=dtype)
    vae = wan_params_from_state_dict(_load_state(pipeline_config["vae_checkpoint_path"]),
                                     device=device, dtype=dtype)
    return WanI2VPipeline(cfg, dit, vcfg, vae, device=device, dtype=dtype)


def load_pipeline(pipeline_config: dict, device="cuda"):
    """The pipeline the yaml describes: :func:`create_ltx_video_pipeline`,
    wrapped in the two-pass multi-scale pipeline with its latent upsampler
    for ``pipeline_type: multi-scale``; :func:`load_wan_pipeline` for
    ``pipeline_type: wan-i2v``."""
    if pipeline_config.get("pipeline_type") == "wan-i2v":
        return load_wan_pipeline(pipeline_config, device=device)
    pipeline = create_ltx_video_pipeline(
        pipeline_config["checkpoint_path"],
        precision=pipeline_config.get("precision", "bfloat16"),
        sampler=pipeline_config.get("sampler"),
        vae_ckpt_path=pipeline_config.get("vae_checkpoint_path"),
        # "w8" (int8 weights) or "w8a8" (int8 products; utils/quantize.py)
        quantize=pipeline_config.get("quantization"),
        quantize_vae=pipeline_config.get("quantization_vae"),
        scan_blocks=bool(pipeline_config.get("scan_blocks", False)),
        device=device,
    )
    if pipeline_config.get("pipeline_type") == "multi-scale":
        from avatar_tpu_torch.models.latent_upsampler import load_latent_upsampler
        from avatar_tpu_torch.pipelines.multiscale import LTXMultiScalePipeline

        up_cfg, up_params = load_latent_upsampler(
            pipeline_config["spatial_upscaler_model_path"], device=device)
        pipeline = LTXMultiScalePipeline(pipeline, up_cfg, up_params)
    return pipeline


def _encode_prompts(config: InferenceConfig, pipeline_config: dict, device):
    """(embeds, mask, negative embeds, negative mask): from the
    ``prompt_embeds_path`` safetensors (keys prompt_embeds,
    prompt_attention_mask and, optionally, the negative_ ones), else the
    T5 encoder of ``text_encoder_model_name_or_path`` and its tokenizer."""
    if config.prompt_embeds_path:
        from avatar_tpu_torch.utils.safetensors_io import load_safetensors

        t, _ = load_safetensors(config.prompt_embeds_path)

        def get(name):
            return t[name].to(device) if name in t else None

        return (get("prompt_embeds"), get("prompt_attention_mask"),
                get("negative_prompt_embeds"), get("negative_prompt_attention_mask"))

    from transformers import T5TokenizerFast

    from avatar_tpu_torch.models.t5 import encode_prompt, load_t5_encoder

    model_path = pipeline_config.get("text_encoder_model_name_or_path",
                                     "PixArt-alpha/PixArt-XL-2-1024-MS")
    t5_cfg, t5_params = load_t5_encoder(
        model_path, quantize=pipeline_config.get("quantization_text_encoder"),
        device=device)
    tokenizer = T5TokenizerFast.from_pretrained(model_path, subfolder="tokenizer")
    embeds, mask = encode_prompt(t5_params, t5_cfg, tokenizer, config.prompt)
    neg_embeds, neg_mask = encode_prompt(t5_params, t5_cfg, tokenizer,
                                         config.negative_prompt)
    return embeds, mask, neg_embeds, neg_mask


_STG_MODES = {
    "stg_av": "AttentionValues", "attention_values": "AttentionValues",
    "stg_as": "AttentionSkip", "attention_skip": "AttentionSkip",
    "stg_r": "Residual", "residual": "Residual",
    "stg_t": "TransformerBlock", "transformer_block": "TransformerBlock",
}


def generate_wan(config: InferenceConfig, pipeline_config: dict, pipeline=None,
                 conditioning: Optional[Sequence] = None) -> np.ndarray:
    """:func:`generate` for ``pipeline_type: wan-i2v``: the yaml's frames,
    height and width (the published 81 x 480 x 832 by default; they set
    ``config``'s), its steps, guidance and shift; the reference image from
    ``conditioning[0]`` ([1, 1, H, W, 3] in [-1, 1]) or the first
    conditioning media path; from ``prompt_embeds_path``: ``prompt_embeds``
    [1, L, 4096] (rows where ``prompt_attention_mask`` is 0 zeroed, padded
    with zero rows to the model's text length), optionally the negative
    ones, and ``clip_embeds`` [1, 257, 1280]. Returns uint8 frames [B, F,
    H, W, 3] on the host."""
    from avatar_tpu_torch.data.media import load_media_file
    from avatar_tpu_torch.pipelines.wan_i2v import WanGenerationParams
    from avatar_tpu_torch.utils.safetensors_io import load_safetensors

    seed_everything(config.seed)
    config.num_frames = pipeline_config.get("num_frames", 81)
    config.height = pipeline_config.get("height", 480)
    config.width = pipeline_config.get("width", 832)
    if pipeline is None:
        pipeline = load_pipeline(pipeline_config, device=config.device)
    device = pipeline.device
    if conditioning is None:
        if not config.conditioning_media_paths:
            raise ValueError("wan-i2v needs the reference image as the first "
                             "conditioning_media_paths entry")
        image = load_media_file(config.conditioning_media_paths[0], config.height,
                                config.width, (0, 0, 0, 0))[:, :1]
    else:
        image = conditioning[0]
    if not config.prompt_embeds_path:
        raise ValueError("wan-i2v takes its umT5 and CLIP embeddings from prompt_embeds_path "
                         "(prompt_embeds, clip_embeds): the port has no umT5 or CLIP encoder")
    t, _ = load_safetensors(config.prompt_embeds_path)
    text_len = pipeline.dit_cfg.text_len

    def padded(name):
        if name not in t:
            return None
        e = t[name].float()
        mask = t.get(name.replace("embeds", "attention_mask"))
        if mask is not None:
            e = e * mask.float()[..., None]
        return torch.nn.functional.pad(e, (0, 0, 0, text_len - e.shape[1])).to(device)

    params = WanGenerationParams(
        height=config.height, width=config.width, num_frames=config.num_frames,
        num_inference_steps=pipeline_config.get("num_inference_steps", 40),
        guidance_scale=pipeline_config.get("guidance_scale", 5.0),
        shift=pipeline_config.get("shift", 3.0))
    generator = torch.Generator(device=device).manual_seed(config.seed)
    frames = pipeline(params, generator, torch.as_tensor(image).to(device),
                      padded("prompt_embeds"), t["clip_embeds"].to(device),
                      negative_text_embeds=padded("negative_prompt_embeds"),
                      output_type="uint8")
    return frames.cpu().numpy()


def generate(config: InferenceConfig, pipeline_config: dict, pipeline=None,
             conditioning: Optional[Sequence] = None) -> np.ndarray:
    """One run of the CLI's pipeline from a parsed yaml: the cropped uint8
    frames [B, num_frames, height, width, 3] on the host. ``pipeline``: one
    :func:`load_pipeline` already made from this yaml (else it is loaded).
    ``conditioning``: the conditioning media already loaded, in place of
    ``config.conditioning_media_paths``, as :func:`load_media_file` gives
    them (the reference image [1, 1, H, W, 3], then the pose frames [1, F,
    H, W, 3]; padded, in [-1, 1]); the frames then follow the pose frames'
    count, as they follow the folder's. The noise comes from a generator on
    the pipeline's device seeded with ``config.seed``."""
    if pipeline_config.get("pipeline_type") == "wan-i2v":
        return generate_wan(config, pipeline_config, pipeline, conditioning)
    from avatar_tpu_torch.data.media import calculate_padding, load_media_file, unpad_media
    from avatar_tpu_torch.models.dit import SkipLayerStrategy
    from avatar_tpu_torch.pipelines.pipeline import GenerationParams

    seed_everything(config.seed)
    # the number of frames follows the pose-frame folder
    cond_paths = config.conditioning_media_paths or []
    if conditioning is not None and cond_paths:
        raise ValueError("pass conditioning_media_paths or loaded conditioning, not both")
    if len(cond_paths) >= 2 and Path(cond_paths[1]).is_dir():
        config.num_frames = len(list(Path(cond_paths[1]).iterdir()))
    if conditioning is not None and len(conditioning) >= 2:
        config.num_frames = conditioning[1].shape[1]
    height_padded = ((config.height - 1) // 32 + 1) * 32
    width_padded = ((config.width - 1) // 32 + 1) * 32
    padding = calculate_padding(config.height, config.width, height_padded, width_padded)

    window = config.window_frames or pipeline_config.get("window_frames", 0)
    windowed = bool(window) and config.num_frames > window
    if windowed and pipeline_config.get("pipeline_type") == "multi-scale":
        raise ValueError("long-video windowing does not compose with the multi-scale "
                         "pipeline; drop window_frames or pipeline_type")
    if windowed and config.input_media_path:
        raise ValueError("long-video windowing does not take input_media_path")
    if pipeline is None:
        pipeline = load_pipeline(pipeline_config, device=config.device)
    device = pipeline.device

    def media(path):
        return torch.from_numpy(load_media_file(path, config.height, config.width,
                                                padding)).to(device)

    conditioning = ([media(p) for p in cond_paths] if conditioning is None
                    else [torch.as_tensor(m).to(device) for m in conditioning])
    strategy = SkipLayerStrategy[_STG_MODES[
        pipeline_config.get("stg_mode", "attention_values").lower()]]
    embeds, mask, neg_embeds, neg_mask = _encode_prompts(config, pipeline_config, device)
    params = GenerationParams(
        height=height_padded,
        width=width_padded,
        num_frames=config.num_frames - 1,
        frame_rate=config.frame_rate,
        num_inference_steps=pipeline_config.get("num_inference_steps", 40),
        guidance_scale=pipeline_config.get("guidance_scale", 1.0),
        stg_scale=pipeline_config.get("stg_scale", 0.0),
        rescaling_scale=pipeline_config.get("rescaling_scale", 1.0),
        skip_block_list=pipeline_config.get("skip_block_list"),
        skip_layer_strategy=strategy,
        decode_timestep=pipeline_config.get("decode_timestep", 0.0),
        decode_noise_scale=pipeline_config.get("decode_noise_scale"),
        stochastic_sampling=pipeline_config.get("stochastic_sampling", False),
        image_cond_noise_scale=config.image_cond_noise_scale,
        cfg_star_rescale=pipeline_config.get("cfg_star_rescale", False),
        solver=pipeline_config.get("solver", "euler"),
    )
    media_items = media(config.input_media_path) if config.input_media_path else None
    ref_image = conditioning[0] if conditioning else None
    pose_frames = conditioning[1] if len(conditioning) > 1 else None
    generator = torch.Generator(device=device).manual_seed(config.seed)

    if windowed:
        from avatar_tpu_torch.pipelines.long_video import LongVideoParams, generate_long_video

        long = LongVideoParams(
            num_frames=config.num_frames, window_frames=window,
            overlap_frames=(config.overlap_frames  # the flag wins when set
                            or pipeline_config.get("overlap_frames") or 9))
        images = generate_long_video(
            pipeline, params, long, generator, embeds, mask,
            negative_prompt_embeds=neg_embeds, negative_prompt_attention_mask=neg_mask,
            ref_image=ref_image, pose_frames=pose_frames, output_type="uint8")
    else:
        images = pipeline(params, generator, embeds, mask, neg_embeds, neg_mask,
                          media_items=media_items, ref_image=ref_image,
                          pose_frames=pose_frames, output_type="uint8")
    return unpad_media(images.cpu().numpy(), padding)[:, :config.num_frames]


def write_outputs(video: np.ndarray, config: InferenceConfig, output_dir) -> List[Path]:
    """One file per sample, named as the JAX CLI names them: a PNG for one
    frame, else an mp4."""
    from avatar_tpu_torch.data.media import write_video

    output_dir = Path(output_dir)
    h, w = video.shape[2], video.shape[3]
    paths = []
    for i in range(video.shape[0]):
        ext = ".png" if video.shape[1] == 1 else ".mp4"
        path = output_dir / f"video_output_{i}_{config.seed}_{h}x{w}x{config.num_frames}{ext}"
        write_video(path, video[i], fps=config.frame_rate)
        print(f"Output saved to {path}")
        paths.append(path)
    return paths


def infer(config: InferenceConfig) -> Path:
    pipeline_config = load_pipeline_config(config.pipeline_config)
    output_dir = Path(config.output_path or f"outputs/{datetime.today().strftime('%Y-%m-%d')}")
    output_dir.mkdir(parents=True, exist_ok=True)
    write_outputs(generate(config, pipeline_config), config, output_dir)
    return output_dir


def main(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="avatar_tpu_torch inference")
    for f_name, f_type, default, helptext in [
        ("prompt", str, "", "Prompt for the generation"),
        ("text", str, "", "Text to pronounce"),
        ("output_path", str, None, "Output folder"),
        ("pipeline_config", str, "configs/inference-avatars.yaml", "Pipeline yaml"),
        ("seed", int, 171198, "Random seed"),
        ("height", int, 192, "Output height"),
        ("width", int, 320, "Output width"),
        ("num_frames", int, 121, "Number of frames"),
        ("frame_rate", int, 20, "Output frame rate"),
        ("negative_prompt", str, InferenceConfig.negative_prompt, ""),
        ("input_media_path", str, None, "vid2vid input"),
        ("image_cond_noise_scale", float, 0.0, ""),
        ("faceformer_checkpoint", str, InferenceConfig.faceformer_checkpoint, ""),
        ("flame_template", str, InferenceConfig.flame_template, ""),
        ("prompt_embeds_path", str, None, "Precomputed T5 embeddings"),
        ("window_frames", int, 0, "Long video: frames per window (%8==1)"),
        ("overlap_frames", int, 0, "Long video: handoff overlap (%8==1)"),
        ("device", str, "cuda", "cuda (default) or cpu"),
    ]:
        parser.add_argument(f"--{f_name}", type=f_type, default=default, help=helptext)
    parser.add_argument("--conditioning_media_paths", type=str, nargs="*", default=None)
    parser.add_argument("--conditioning_strengths", type=float, nargs="*", default=None)
    args, _ = parser.parse_known_args(argv)
    config = InferenceConfig(**vars(args))
    # --text: detect the face in the reference image, render FaceFormer pose
    # frames for the text, and take their directory as the pose frames
    if config.text and config.conditioning_media_paths:
        from PIL import Image

        from avatar_tpu_torch.pipelines.pose_frames import (
            detect_face_bbox, generate_faceformer_frames,
        )

        image = np.asarray(Image.open(config.conditioning_media_paths[0]).convert("RGB"))
        frames_dir = generate_faceformer_frames(
            config.text,
            output_dir=Path(config.output_path or "outputs") / "pose_frames",
            faceformer_checkpoint=config.faceformer_checkpoint,
            template_path=config.flame_template, face_bbox=detect_face_bbox(image),
            target_fps=config.frame_rate, height=config.height, width=config.width,
            device=config.device)
        config.conditioning_media_paths = [config.conditioning_media_paths[0],
                                           str(frames_dir)]
    return infer(config)


if __name__ == "__main__":
    main()
