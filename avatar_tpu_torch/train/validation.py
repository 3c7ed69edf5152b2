"""Validation videos with quality metrics (port of
``avatar_tpu/train/validation.py``).

The loss epoch is ``train/train.py:validate_step_fn``. :func:`validate_video`
runs the whole pipeline for each validation sample (the clip's stored ref
and pose latents as conditioning), writes the reconstruction video and,
where the optional ``lpips`` and ``torchmetrics`` packages import, computes
per-frame LPIPS and FID against the target clip; without them it warns and
writes the videos only.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch


def _try_load_metrics(device="cpu"):
    """(lpips_metric, fid_metric), or (None, None) with a warning where
    ``lpips`` or ``torchmetrics`` is not installed."""
    try:
        from lpips import LPIPS
        from torchmetrics.image.fid import FrechetInceptionDistance

        return (LPIPS(net="vgg").to(device).eval(),
                FrechetInceptionDistance(normalize=True).to(device))
    except ImportError:
        warnings.warn("lpips/torchmetrics not installed — validate_video will skip "
                      "LPIPS/FID and only write reconstruction videos.")
        return None, None


def compute_lpips_fid(recon: np.ndarray, target: np.ndarray, lpips_metric,
                      fid_metric) -> Dict[str, float]:
    """The mean per-frame LPIPS and the FID over the frames of two uint8
    [F, H, W, 3] videos, cropped to their common size and length."""
    h = min(target.shape[1], recon.shape[1])
    w = min(target.shape[2], recon.shape[2])
    target, recon = target[:, :h, :w], recon[:, :h, :w]
    n = min(target.shape[0], recon.shape[0])

    lpips_vals = []
    for i in range(n):
        a = torch.from_numpy(recon[i]).permute(2, 0, 1)[None].float() / 255.0
        b = torch.from_numpy(target[i]).permute(2, 0, 1)[None].float() / 255.0
        lpips_vals.append(float(lpips_metric(a * 2 - 1, b * 2 - 1).item()))

    recon_t = torch.from_numpy(recon[:n]).permute(0, 3, 1, 2).float() / 255.0
    tgt_t = torch.from_numpy(target[:n]).permute(0, 3, 1, 2).float() / 255.0
    fid_metric.update(recon_t, real=False)
    fid_metric.update(tgt_t, real=True)
    return {"lpips": sum(lpips_vals) / max(1, len(lpips_vals)),
            "fid": float(fid_metric.compute().item())}


def validate_video(
    pipeline,
    val_dataset,
    output_dir: str,
    prompt_embeds: torch.Tensor,
    prompt_attention_mask: torch.Tensor,
    videos_dir: Optional[str] = None,
    num_samples: int = 4,
    frame_rate: int = 22,
    num_inference_steps: int = 40,
    generator: Optional[torch.Generator] = None,
) -> List[Dict]:
    """For the first ``num_samples`` items of ``val_dataset``: generate the
    clip with ``pipeline`` (an ``LTXVideoPipeline`` with the current
    weights) from its ref and pose latents, guidance 1, decode timestep
    0.05, the clip's size and length; write ``val_recon_{stem}.mp4`` to
    ``output_dir``, and where ``videos_dir`` holds ``{stem}.mp4`` and the
    metric packages import, its LPIPS and FID. Noise from ``generator``
    (default seed 0, on the pipeline's device). Returns one record a
    sample: stem, video path and, where computed, lpips and fid."""
    from avatar_tpu_torch.data.media import read_video_frames, write_video
    from avatar_tpu_torch.pipelines.pipeline import GenerationParams

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    device = prompt_embeds.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    lpips_metric, fid_metric = _try_load_metrics()

    results = []
    for idx in range(min(num_samples, len(val_dataset))):
        item = val_dataset[idx]
        stem = item["stem"]

        def latent(name):
            return torch.from_numpy(np.ascontiguousarray(item[name]))[None].to(device)

        latents, pose, ref = latent("latents"), latent("pose_latents"), latent(
            "ref_image_latents")
        f_l, h_l, w_l = latents.shape[1:4]
        params = GenerationParams(
            height=h_l * pipeline.vae_scale_factor, width=w_l * pipeline.vae_scale_factor,
            num_frames=(f_l - 1) * pipeline.video_scale_factor, frame_rate=frame_rate,
            num_inference_steps=num_inference_steps, guidance_scale=1.0, stg_scale=0.0,
            rescaling_scale=1.0, decode_timestep=0.05)
        images = pipeline(params, generator, prompt_embeds, prompt_attention_mask,
                          ref_latents=ref, pose_latents=pose)
        recon = (np.clip(images[0].float().cpu().numpy(), 0, 1) * 255).astype(np.uint8)

        out_path = out / f"val_recon_{stem}.mp4"
        write_video(out_path, recon / 255.0, fps=frame_rate)

        record = {"stem": stem, "video": str(out_path)}
        target_path = Path(videos_dir) / f"{stem}.mp4" if videos_dir else None
        if lpips_metric is not None and target_path is not None and target_path.exists():
            target = np.stack(list(read_video_frames(target_path)), axis=0)
            record.update(compute_lpips_fid(recon, target, lpips_metric, fid_metric))
            print(f"[val video] {stem}: lpips={record['lpips']:.4f}, "
                  f"fid={record['fid']:.4f}, saved={out_path}")
        else:
            print(f"[val video] {stem}: saved={out_path} (metrics skipped)")
        results.append(record)
    return results
