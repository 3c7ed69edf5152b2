from avatar_tpu_torch.pipelines.long_video import (
    LongVideoParams,
    generate_long_video,
    window_starts,
)
from avatar_tpu_torch.pipelines.pipeline import (
    ConditioningItem,
    GenerationParams,
    LTXVideoPipeline,
    adain_filter_latent,
    tone_map_latents,
)
from avatar_tpu_torch.pipelines.serving import AvatarServer, GenerationRequest

__all__ = [
    "AvatarServer",
    "GenerationRequest",
    "ConditioningItem",
    "GenerationParams",
    "LTXVideoPipeline",
    "LongVideoParams",
    "adain_filter_latent",
    "generate_long_video",
    "tone_map_latents",
    "window_starts",
]
