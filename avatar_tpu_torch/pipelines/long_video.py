"""Long-video generation by windowed denoising with a pixel-space handoff
(port of ``avatar_tpu/pipelines/long_video.py``).

The target video is split into overlapping windows of ``window_frames``;
each runs through the standard pipeline, and every window after the first
is conditioned on the decoded tail of the one before through a frame-0
``ConditioningItem`` (the causal VAE re-encodes those frames as a fresh
first segment, so the handed-over region is exactly representable). A
later window's latents may be AdaIN-matched to window 0's
(``adain_anchor``), and the regenerated overlap is crossfaded into the
previous window's tail (``blend_overlap``). Each window has the same
token count, so the cost is linear in the video's length.

``window_frames`` and ``overlap_frames`` are 8k + 1 (the causal VAE's
temporal factor is 8), so the stride ``window - overlap`` is a multiple
of 8 and the windows tile the timeline exactly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from avatar_tpu_torch.pipelines.pipeline import (
    ConditioningItem,
    GenerationParams,
    LTXVideoPipeline,
    adain_filter_latent,
)


@dataclass
class LongVideoParams:
    """Windowing knobs of :func:`generate_long_video`.

    num_frames: pixel frames to emit (the last window is generated whole
        and the output trimmed). window_frames: frames per window (8k + 1).
    overlap_frames: frames handed from one window to the next (8k + 1,
        below window_frames). handoff_strength: the handed-over frames'
        conditioning strength (1 freezes them). blend_overlap: crossfade
        the regenerated overlap into the previous tail. adain_anchor:
        AdaIN every later window's latents to window 0's statistics.
    """

    num_frames: int
    window_frames: int = 97
    overlap_frames: int = 9
    handoff_strength: float = 1.0
    blend_overlap: bool = True
    adain_anchor: bool = False

    def __post_init__(self):
        if self.window_frames % 8 != 1:
            raise ValueError(f"window_frames must be % 8 == 1, got {self.window_frames}")
        if self.overlap_frames % 8 != 1:
            raise ValueError(f"overlap_frames must be % 8 == 1, got {self.overlap_frames}")
        if not 0 < self.overlap_frames < self.window_frames:
            raise ValueError(
                f"overlap_frames must be in (0, window_frames), got "
                f"{self.overlap_frames} vs {self.window_frames}")
        if self.num_frames < 1:
            raise ValueError(f"num_frames must be >= 1, got {self.num_frames}")


def window_starts(total: int, window: int, overlap: int) -> List[int]:
    """Start frames of the windows covering ``total`` frames."""
    if total <= window:
        return [0]
    stride = window - overlap
    n = 1 + int(np.ceil((total - window) / stride))
    return [i * stride for i in range(n)]


def _slice_pose(pose: torch.Tensor, start: int, frames: int) -> torch.Tensor:
    """One window's [B, frames, H, W, 3] slice of the pose frames, padded
    with the last frame where the sequence runs short."""
    end, f = start + frames, pose.shape[1]
    if end <= f:
        return pose[:, start:end]
    pad = pose[:, f - 1:f].expand(-1, end - f, -1, -1, -1)
    return torch.cat([pose[:, start:f], pad], dim=1)


def generate_long_video(
    pipeline: LTXVideoPipeline,
    params: GenerationParams,
    long: LongVideoParams,
    generator: torch.Generator,
    prompt_embeds: torch.Tensor,
    prompt_attention_mask: torch.Tensor,
    *,
    negative_prompt_embeds: Optional[torch.Tensor] = None,
    negative_prompt_attention_mask: Optional[torch.Tensor] = None,
    conditioning_items: Optional[List[ConditioningItem]] = None,
    ref_image: Optional[torch.Tensor] = None,
    pose_frames: Optional[torch.Tensor] = None,
    output_type: str = "np",
    dtype: torch.dtype = torch.bfloat16,
    ref_noise: Optional[torch.Tensor] = None,
    window_noise: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
) -> torch.Tensor:
    """``long.num_frames`` frames as overlapping windows: [B, num_frames,
    H, W, 3] on the pipeline's device, f32 in [0, 1] for "np", uint8 for
    "uint8".

    ``params.num_frames`` is replaced by the window's; ``conditioning_items``
    apply to the first window only; ``pose_frames`` spans the whole video
    and is sliced per window. The reference image is encoded once. Every
    draw comes from ``generator`` unless given: ``ref_noise`` (the
    reference's encoder draw) and ``window_noise[i]``, window i's noise
    arguments of the pipeline call (``init_noise``, ``pose_noise``,
    ``item_noise`` ...) plus its ``decode_noise``.
    """
    if output_type not in ("np", "uint8"):
        raise ValueError(f"long video stitches whole frames: output_type must be "
                         f"'np' or 'uint8', got {output_type!r}")
    W, V, T = long.window_frames, long.overlap_frames, long.num_frames
    starts = window_starts(T, W, V)
    if window_noise is not None and len(window_noise) != len(starts):
        raise ValueError(f"{len(window_noise)} window noise sets for {len(starts)} windows")
    p_win = dataclasses.replace(params, num_frames=W)
    dev = pipeline.device

    ref_lat = None
    if ref_image is not None:
        ref_lat = pipeline.encode_media(ref_image.to(dev, dtype), generator, ref_noise,
                                        p_win.vae_per_channel_normalize)

    anchor = out = None
    for i, s in enumerate(starts):
        noise = dict(window_noise[i]) if window_noise is not None else {}
        decode_noise = noise.pop("decode_noise", None)
        cond = conditioning_items if i == 0 else [ConditioningItem(
            media_item=out[:, s:s + V] * 2.0 - 1.0, media_frame_number=0,
            conditioning_strength=long.handoff_strength)]
        latents = pipeline(
            p_win, generator, prompt_embeds, prompt_attention_mask,
            negative_prompt_embeds=negative_prompt_embeds,
            negative_prompt_attention_mask=negative_prompt_attention_mask,
            conditioning_items=cond, ref_latents=ref_lat,
            pose_frames=None if pose_frames is None else _slice_pose(pose_frames, s, W),
            output_type="latent", dtype=dtype, **noise)
        if long.adain_anchor:
            if anchor is None:
                anchor = latents
            else:
                latents = adain_filter_latent(latents, anchor)
        frames = pipeline.decode_latents(latents, p_win, generator, noise=decode_noise,
                                         output_type="np").float()
        if i == 0:
            b, _, h, w, c = frames.shape
            out = torch.zeros((b, starts[-1] + W, h, w, c), dtype=torch.float32,
                              device=frames.device)
            out[:, :W] = frames
        else:
            if long.blend_overlap:
                # linear crossfade: the old tail keeps full weight at the
                # overlap's first frame, the new window takes over by its last
                wgt = torch.linspace(0.0, 1.0, V, dtype=torch.float32,
                                     device=frames.device).reshape(1, V, 1, 1, 1)
                out[:, s:s + V] = (1.0 - wgt) * out[:, s:s + V] + wgt * frames[:, :V]
            out[:, s + V:s + W] = frames[:, V:]
    out = out[:, :T]
    if output_type == "uint8":
        return (out * 255.0 + 0.5).to(torch.uint8)
    return out
