"""Serving layer: dynamic-batched, fetch-overlapped avatar generation (port
of ``avatar_tpu/pipelines/serving.py``).

- Requests are grouped by bucket (:func:`_bucket_key`: every
  ``GenerationParams`` field and the request's shape), and same-bucket
  requests that arrive within ``batch_window_s`` of each other are
  coalesced into one batched generation of up to ``max_batch``; a batch
  runs with its leader's params and a generator seeded from the leader's
  seed.
- Each request's initial noise comes from its own seed (the pipeline's
  ``sample_seeds``), so its video does not depend on the batch it landed
  in (decode-time noise, when enabled, still comes from the batch's
  generator).
- Avatar media (reference image, pose frames) are cached on the device as
  VAE latents, keyed by the host array's identity (:class:`_LatentCache`):
  each distinct array is shipped and encoded once, as bf16 with a
  generator seeded 0, so a request's conditioning does not depend on its
  batch either. ``media_cache_size=0`` ships the pixels with every batch
  and encodes them with the batch's generator.
- The copy of a batch's output to the host overlaps the next batch's
  compute: a ``non_blocking`` copy into pinned host memory on a side
  stream, ordered after the generation, with an event that
  :meth:`AvatarServer._drain_fetches` waits on.

The JAX package's data-parallel padding (a batch padded to the mesh size)
has no counterpart: the port's pipeline runs on one device. All device
work runs on the worker thread; callers get futures whose results are
numpy arrays (bf16 outputs as f32).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import weakref
from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from avatar_tpu_torch.pipelines.pipeline import GenerationParams, LTXVideoPipeline


@dataclass
class GenerationRequest:
    """One avatar generation: text embeddings and optional avatar media,
    numpy arrays (or tensors) on the host."""

    params: GenerationParams
    prompt_embeds: Any  # [1, L, caption_channels]
    prompt_attention_mask: Any  # [1, L]
    ref_image: Optional[Any] = None  # [1, 1, H, W, 3]
    pose_frames: Optional[Any] = None  # [1, F, H, W, 3]
    seed: int = 0
    output_type: str = "yuv420"


def _bucket_key(req: GenerationRequest) -> Tuple:
    """Coalescing key: every ``GenerationParams`` field (a batch runs with
    its leader's params, so any field that differs across coalesced
    requests would silently generate the wrong thing), plus the request's
    shape fields."""
    p = req.params
    return (
        tuple(_as_tuple(getattr(p, f.name)) for f in dataclasses.fields(GenerationParams)),
        tuple(req.prompt_embeds.shape), req.ref_image is not None,
        req.pose_frames is not None, req.output_type,
    )


def _as_tuple(v):
    if isinstance(v, (list, tuple)):
        return tuple(_as_tuple(x) for x in v)
    return v


class _LatentCache:
    """Identity-keyed host media -> device latents, least recently used
    first out.

    An entry holds a weak reference to the host array beside its latents:
    an ``id()`` key is valid only while the array lives, and the weak
    reference keeps the cache from pinning pixels that the caller dropped
    (38 MB of pose frames per 97-frame 256 px request). The latents are
    some 200 times smaller than the pixels, so ``capacity`` prices only
    them. A hit needs the caller to pass the same array object again, the
    pattern of resident avatar assets.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._entries: "OrderedDict[Tuple, Tuple[Any, Any]]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, media, extra_key, encode):
        key = (id(media), extra_key)
        ent = self._entries.get(key)
        if ent is not None and ent[0]() is media:
            self._entries.move_to_end(key)
            self.hits += 1
            return ent[1]
        self.misses += 1
        latents = encode(media)
        try:
            ref = weakref.ref(media)
        except TypeError:  # media that takes no weak reference is not cached
            return latents
        self._entries[key] = (ref, latents)
        self._entries.move_to_end(key)
        # dead entries go first (their id() may be reused), then the oldest
        for k in [k for k, (r, _) in self._entries.items() if r() is None]:
            del self._entries[k]
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
        return latents


def _host(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


class AvatarServer:
    """Dynamic-batching request server over one :class:`LTXVideoPipeline`.

    Usage::

        server = AvatarServer(pipeline, max_batch=4)
        fut = server.submit(GenerationRequest(...))
        video = fut.result()   # numpy frames
        server.shutdown()

    Batches run in the pipeline call's default working type, bf16.
    """

    def __init__(
        self,
        pipeline: LTXVideoPipeline,
        max_batch: int = 4,
        batch_window_s: float = 0.02,
        media_cache_size: int = 64,
    ):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self._media_cache = _LatentCache(media_cache_size)
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self._pending_fetch: List[Tuple[List[Future], Any]] = []
        device = pipeline.device
        self._copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.stats: Dict[str, int] = {"batches": 0, "requests": 0}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client API -------------------------------------------------------

    def submit(self, request: GenerationRequest) -> Future:
        if self._closed:
            raise RuntimeError("server is shut down")
        fut: Future = Future()
        self._queue.put((request, fut))
        return fut

    def shutdown(self, wait: bool = True) -> None:
        self._closed = True
        self._queue.put(None)
        if wait:
            self._worker.join()

    # -- worker -----------------------------------------------------------

    def _collect_batch(self):
        """Block for one request, then coalesce the same-bucket requests
        that arrive within the batch window."""
        first = self._queue.get()
        if first is None:
            return None
        key = _bucket_key(first[0])
        batch = [first]
        while len(batch) < self.max_batch:
            try:
                item = self._queue.get(timeout=self.batch_window_s)
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # signal the shutdown again
                break
            if _bucket_key(item[0]) == key:
                batch.append(item)
            else:
                self._queue.put(item)  # another bucket: the next round
                break
        return batch

    def _run(self) -> None:
        device = self.pipeline.device
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        with torch.no_grad():
            while True:
                batch = self._collect_batch()
                if batch is None:
                    self._drain_fetches()
                    return
                try:
                    self._dispatch(batch)
                except Exception as e:  # noqa: BLE001 - fails this batch's futures
                    for _, fut in batch:
                        if not fut.done():
                            fut.set_exception(e)
                # the newest generation stays in flight only while more
                # work is queued (its copy then overlaps the next batch's
                # compute); otherwise everything resolves
                self._drain_fetches(keep_last=not self._queue.empty())

    def _dispatch(self, batch) -> None:
        reqs = [r for r, _ in batch]
        futs = [f for _, f in batch]
        r0 = reqs[0]
        pipe = self.pipeline

        def stack(getter):
            parts = [getter(r) for r in reqs]
            if any(p is None for p in parts):
                return None
            return torch.cat([_host(p) for p in parts])

        embeds = stack(lambda r: r.prompt_embeds)
        mask = stack(lambda r: r.prompt_attention_mask)
        ref = pose = ref_lat = pose_lat = None
        if self._media_cache.capacity > 0:
            # each distinct host array is shipped and encoded once, with a
            # fixed generator, and batches concatenate the cached latents
            pcn = r0.params.vae_per_channel_normalize

            def encode_one(media):
                gen = torch.Generator(device=pipe.device).manual_seed(0)
                return pipe.encode_media(_host(media).to(torch.bfloat16), gen,
                                         per_channel_normalize=pcn)

            def stack_latents(getter):
                parts = [getter(r) for r in reqs]
                if any(p is None for p in parts):
                    return None
                return torch.cat([self._media_cache.get(p, pcn, encode_one)
                                  for p in parts])

            ref_lat = stack_latents(lambda r: r.ref_image)
            pose_lat = stack_latents(lambda r: r.pose_frames)
        else:
            ref = stack(lambda r: r.ref_image)
            pose = stack(lambda r: r.pose_frames)
        generator = torch.Generator(device=pipe.device).manual_seed(r0.seed)
        out = pipe(
            r0.params, generator, embeds, mask,
            ref_image=ref, pose_frames=pose, ref_latents=ref_lat, pose_latents=pose_lat,
            output_type=r0.output_type,
            # each sample's initial noise from its own request's seed
            sample_seeds=[r.seed for r in reqs],
        )
        self._pending_fetch.append((futs, self._fetch(out)))
        self.stats["batches"] += 1
        self.stats["requests"] += len(reqs)

    def _fetch(self, out: torch.Tensor):
        """Start the copy of ``out`` to the host: (host tensor, event or
        None, the device tensor kept alive until the copy is done)."""
        if self._copy_stream is None:
            return out, None, None
        self._copy_stream.wait_stream(torch.cuda.current_stream(out.device))
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        with torch.cuda.stream(self._copy_stream):
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return host, done, out

    def _drain_fetches(self, keep_last: bool = False) -> None:
        """Resolve finished generations; with ``keep_last`` the newest stays
        in flight, so that its copy overlaps the next batch's compute."""
        limit = 1 if keep_last else 0
        while len(self._pending_fetch) > limit:
            futs, (host, done, _) = self._pending_fetch.pop(0)
            if done is not None:
                done.synchronize()
            if host.dtype == torch.bfloat16:
                host = host.float()
            arr = host.numpy()
            for i, fut in enumerate(futs):
                if not fut.done():
                    fut.set_result(arr[i])
