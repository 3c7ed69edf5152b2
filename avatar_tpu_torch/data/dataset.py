"""Latent-pair dataset for avatar training (port of
``avatar_tpu/data/dataset.py``).

Pairs ``{stem}`` encoder latents with ``{stem}`` pose latents and
``{stem}_ref`` reference-image latents across two directories. Host-side
numpy only:
- reads ``.safetensors`` (the port's own reader), torch-pickle ``.pt``,
  ``.npz`` and ``.npy`` latent files, each holding the latents in the
  reference's [C, F, H, W] layout (a dict or archive under "latents");
- converts them to channels-last [F, H, W, C];
- batches with a deterministic shuffled epoch iterator (the JAX package's
  numpy shuffle, so both packages give the same order for a seed) and
  groups micro-batches for gradient accumulation.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

LATENT_SUFFIXES = (".safetensors", ".pt", ".npz", ".npy")


def _load_latent_file(path: Path) -> np.ndarray:
    """Load a latents file -> numpy [C, F, H, W] (reference layout)."""
    if path.suffix == ".pt":
        import torch

        data = torch.load(path, map_location="cpu", weights_only=False)
        latents = data["latents"] if isinstance(data, dict) else data
        return latents.squeeze().float().numpy()
    if path.suffix == ".safetensors":
        from avatar_tpu_torch.utils.safetensors_io import load_safetensors

        tensors, _ = load_safetensors(path)
        return tensors["latents"].float().numpy().squeeze()
    if path.suffix == ".npz":
        return np.load(path)["latents"].astype(np.float32).squeeze()
    if path.suffix == ".npy":
        return np.load(path).astype(np.float32).squeeze()
    raise ValueError(f"Unsupported latent file: {path}")


def _find_latent(directory: Path, stem: str) -> Optional[Path]:
    for suffix in LATENT_SUFFIXES:
        p = directory / f"{stem}{suffix}"
        if p.exists():
            return p
    return None


class LatentPairDataset:
    """Items {"latents", "pose_latents", "ref_image_latents", "stem"} over
    the stems that have all three files; optional ``{stem}_ff.npy`` audio
    latents and ``{stem}_pixels.npy`` pixel targets ride along."""

    def __init__(self, condition_latents_dir: str, encoder_latents_dir: str):
        self.condition_dir = Path(condition_latents_dir)
        self.encoder_dir = Path(encoder_latents_dir)
        stems = sorted(
            {
                p.stem
                for p in self.encoder_dir.glob("*")
                if p.suffix in LATENT_SUFFIXES
                and not p.stem.endswith(("_ref", "_ff", "_pixels"))
            }
        )
        self.items = [
            s
            for s in stems
            if _find_latent(self.condition_dir, s) is not None
            and _find_latent(self.condition_dir, f"{s}_ref") is not None
        ]

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        stem = self.items[idx]

        def to_fhwc(x: np.ndarray) -> np.ndarray:
            if x.ndim == 3:  # [C, H, W] ref image -> [1, H, W, C]
                return x.transpose(1, 2, 0)[None]
            return x.transpose(1, 2, 3, 0)  # [C,F,H,W] -> [F,H,W,C]

        latents = to_fhwc(_load_latent_file(_find_latent(self.encoder_dir, stem)))
        pose = to_fhwc(_load_latent_file(_find_latent(self.condition_dir, stem)))
        ref = to_fhwc(
            _load_latent_file(_find_latent(self.condition_dir, f"{stem}_ref"))
        )
        item = {
            "latents": latents,
            "pose_latents": pose,
            "ref_image_latents": ref,
            "stem": stem,
        }
        # optional FaceFormer audio latents ({stem}_ff.npy, save-text-latents
        # output) for audio-conditioned training
        ff_path = self.condition_dir / f"{stem}_ff.npy"
        if ff_path.exists():
            item["audio_latents"] = np.load(ff_path).astype(np.float32)
        # optional pixel targets ({stem}_pixels.npy uint8 [F, H, W, 3],
        # save-vae-latents --save_pixels output) for decoder fine-tuning
        px_path = self.encoder_dir / f"{stem}_pixels.npy"
        if px_path.exists():
            item["pixels"] = np.load(px_path)
        return item


def collate_latent_pairs(batch: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack to [B, F, H, W, C]. Audio latents (variable T) are
    right-padded to the batch max with a keep-mask."""
    out = {
        "latents": np.stack([b["latents"] for b in batch]),
        "pose_latents": np.stack([b["pose_latents"] for b in batch]),
        "ref_image_latents": np.stack([b["ref_image_latents"] for b in batch]),
        "stem": [b["stem"] for b in batch],
    }
    if all("pixels" in b for b in batch):
        out["pixels"] = np.stack([b["pixels"] for b in batch])
    if all("audio_latents" in b for b in batch):
        t_max = max(b["audio_latents"].shape[0] for b in batch)
        padded, mask = [], []
        for b in batch:
            a = b["audio_latents"]
            padded.append(np.pad(a, ((0, t_max - a.shape[0]), (0, 0))))
            m = np.zeros(t_max, np.float32)
            m[: a.shape[0]] = 1.0
            mask.append(m)
        out["audio_latents"] = np.stack(padded)
        out["audio_mask"] = np.stack(mask)
    return out


def epoch_batches(
    dataset: LatentPairDataset,
    batch_size: int,
    accum_steps: int = 1,
    seed: int = 0,
    epoch: int = 0,
    shuffle: bool = True,
    drop_remainder: bool = True,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield macro-batches shaped [accum, micro_b, ...] for the train
    step, deterministic per (seed, epoch). With ``process_count`` > 1 every
    process computes the same global shuffle and yields only its own
    contiguous ``batch_size / process_count`` rows of each micro-batch."""
    if batch_size % process_count != 0:
        raise ValueError(
            f"batch_size {batch_size} not divisible by {process_count} processes"
        )
    local_b = batch_size // process_count
    lo = process_index * local_b
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    macro = batch_size * accum_steps
    end = len(order) - (len(order) % macro) if drop_remainder else len(order)
    for start in range(0, end, macro):
        idxs = order[start : start + macro]
        if len(idxs) < macro:
            break
        # local rows of each micro-batch: [a*batch_size + lo, ... + local_b)
        local_idxs = np.concatenate(
            [idxs[a * batch_size + lo : a * batch_size + lo + local_b]
             for a in range(accum_steps)]
        )
        items = [dataset[int(i)] for i in local_idxs]
        stacked = collate_latent_pairs(items)
        yield {
            k: v.reshape(accum_steps, local_b, *v.shape[1:])
            if isinstance(v, np.ndarray)
            else v
            for k, v in stacked.items()
        }


def prefetch_batches(
    batch_iter: Iterator[Dict[str, np.ndarray]],
    device_put=None,
    depth: int = 2,
) -> Iterator[Dict[str, np.ndarray]]:
    """Background-thread prefetch: overlap disk reads and collation (and
    with ``device_put`` the copy to the device) with the train step, one
    daemon thread behind a bounded queue."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    err: List[BaseException] = []

    def worker():
        try:
            for batch in batch_iter:
                if device_put is not None:
                    batch = {
                        k: device_put(v) if isinstance(v, np.ndarray) else v
                        for k, v in batch.items()
                    }
                q.put(batch)
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            if err:
                raise err[0]
            return
        yield item
