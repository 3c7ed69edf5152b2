"""Training checkpoints (port of ``avatar_tpu/train/checkpoints.py``).

1. **Export**: one single-file safetensors with the trained weights merged
   into the base DiT (LoRA folded in by :func:`merge_lora`, or the "full"
   mode's subtree overlaid), in the reference's parameter names, with the
   transformer and scheduler configs in its metadata
   (:func:`export_training_checkpoint`).
2. **Resume state** (:class:`TrainStateCheckpointer`): the trainable tree,
   the optimizer state, the step and extras, one ``torch.save`` file per
   step. This format is the port's own: the JAX package keeps its resume
   state with orbax, and neither reads the other's.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

from avatar_tpu_torch.core.config import TrainConfig
from avatar_tpu_torch.models.dit import DiTConfig
from avatar_tpu_torch.train.lora import lora_scale, merge_lora
from avatar_tpu_torch.train.train import overlay_params, tree_map
from avatar_tpu_torch.utils.weight_import import save_single_file_checkpoint


def export_training_checkpoint(
    target_path: Union[str, Path],
    dit_params: dict,
    dit_cfg: DiTConfig,
    trainable: dict,
    cfg: TrainConfig,
    metadata: Optional[Dict[str, Any]] = None,
    is_best: bool = False,
) -> Path:
    """Merge ``trainable`` into the base ``dit_params`` (unpermuted) and
    write a single-file checkpoint in the base params' dtype; ``is_best``
    prefixes the file name with ``best_``. ``metadata["scheduler"]``
    entries extend the scheduler config. Returns the path written."""
    if cfg.train_mode == "lora_audio":
        merged = merge_lora(dit_params, trainable["lora"],
                            lora_scale(cfg.lora_rank, cfg.lora_alpha))
        merged = overlay_params(
            merged, {"caption_projection": trainable["caption_projection"]})
    else:
        merged = overlay_params(dit_params, trainable)
    base_dtype = dit_params["patchify_proj"]["weight"].dtype
    merged = tree_map(lambda x: x.detach().to(base_dtype), merged)

    target_path = Path(target_path)
    if is_best:
        target_path = target_path.with_name("best_" + target_path.name)
    target_path.parent.mkdir(parents=True, exist_ok=True)
    scheduler_config = {
        "_class_name": "RectifiedFlowScheduler",
        "num_train_timesteps": cfg.rf_num_train_timesteps,
        "shifting": cfg.rf_shifting,
        "base_resolution": cfg.rf_base_resolution,
        "target_shift_terminal": cfg.rf_target_shift_terminal,
        "sampler": cfg.rf_sampler,
        "shift": cfg.rf_shift,
    }
    if metadata:
        scheduler_config.update(dict(metadata).pop("scheduler", {}))
    save_single_file_checkpoint(target_path, merged, dit_cfg,
                                scheduler_config=scheduler_config)
    return target_path


class TrainStateCheckpointer:
    """(trainable, opt_state, step, extra) resume state as
    ``<directory>/step_<N>.pt`` files written by ``torch.save`` (the
    port's own format), keeping the newest ``max_to_keep``."""

    _NAME = re.compile(r"step_(\d+)\.pt$")

    def __init__(self, directory: Union[str, Path], max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep

    def _steps(self):
        if not self.directory.is_dir():
            return []
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := self._NAME.match(p.name)))

    def save(self, step: int, trainable, opt_state, extra: Optional[dict] = None):
        self.directory.mkdir(parents=True, exist_ok=True)
        payload = {"step": step, "trainable": trainable, "opt_state": opt_state,
                   "extra": extra or {}}
        path = self.directory / f"step_{step}.pt"
        tmp = path.with_suffix(".tmp")
        torch.save(payload, tmp)
        tmp.replace(path)
        for old in self._steps()[:-self.max_to_keep]:
            (self.directory / f"step_{old}.pt").unlink(missing_ok=True)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device=None
                ) -> Optional[Tuple[int, Dict[str, Any]]]:
        """(step, {"trainable", "opt_state", "extra"}) of ``step`` (default
        the latest), tensors on ``device`` (default where they were saved),
        or None when nothing is saved."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        payload = torch.load(self.directory / f"step_{step}.pt", map_location=device,
                             weights_only=True)
        return step, {k: payload[k] for k in ("trainable", "opt_state", "extra")}

    def close(self):
        pass
