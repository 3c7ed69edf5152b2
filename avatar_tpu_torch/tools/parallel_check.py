"""The multi-device layer across the cards of one host: each mode against
the unsharded port on the same inputs, over NCCL.

    python3 -m avatar_tpu_torch.tools.parallel_check [--world N]
    python3 -m avatar_tpu_torch.tools.parallel_check --device cpu --tiny --world 2

Run it from the repo root (it imports ``chip_smoke.py``'s shapes,
tolerances and timers). One process per card (``--world``, default every
card), joined by NCCL on a localhost port (gloo with ``--device cpu``).
At full 2B width (28 blocks, 32 x 64 heads, bf16, random weights from a
seed; ``--tiny``: a 4-block f32 DiT and the demo VAE), every rank runs:

- ``sp``: ``dit_apply_sp`` with Ulysses and with the ring at the long
  operating point (5376 tokens, each rank 5376 / N) against ``dit_apply``;
- ``pp``: ``dit_apply_pp`` over N stages (each rank its 28 / N blocks) on a
  batch of N samples at 832 tokens in N microbatches, against
  ``dit_apply``;
- ``dp``: the pipeline with a ``dp_mesh`` over N ranks on a batch of N
  (97 frames at 256 px, 3 steps) against the pipeline without it on the
  whole batch, the same generator;
- ``train``: one "lora_audio" step (AdamW) in each of "sp" (Ulysses,
  ring), "pp", "zero2" and "fsdp" over N ranks against the one-device step
  on the whole batch (``chip_smoke.py``'s training point, 8 x 480 tokens).

Forward checks are held to ``chip_smoke.KERNEL_PATH_TOL`` relative RMS
(bf16: other kernels and summation orders), steps to its training
tolerances; in f32 (``--tiny``) to 1e-4 and 1e-5. Forward times are CUDA
events over back-to-back calls beside the profiler's device time per
call; the pipeline's and the steps' seconds are a second call's, after a
first that warms up; peak memory is each rank's, with the unsharded
reference's weights resident too. Rank 0 prints one JSON line per check, the
card's name and power limit, and a last line ``{"ok": ...}``; a failed
check exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time


def _rel(a, b) -> float:
    return ((a.float() - b.float()).pow(2).mean().sqrt() / b.float().pow(2).mean().sqrt()).item()


def _models(tiny: bool, device):
    import dataclasses

    import torch

    from avatar_tpu_torch.models.dit import DiTConfig, init_dit
    from avatar_tpu_torch.models.vae import LTX_VAE_CONFIG, VAEConfig, demo_config, init_vae

    dtype = torch.float32 if tiny else torch.bfloat16
    if tiny:
        dcfg = DiTConfig(num_attention_heads=4, attention_head_dim=16, in_channels=8,
                         out_channels=8, num_layers=4, cross_attention_dim=64,
                         caption_channels=32)
        vcfg = dataclasses.replace(demo_config(latent_channels=8), base_channels=32,
                                   decoder_base_channels=32)
    else:
        dcfg = DiTConfig()
        vcfg = VAEConfig.from_dict({**LTX_VAE_CONFIG, "timestep_conditioning": True})
    dit = init_dit(dcfg, seed=1, device=device, dtype=dtype)
    vae = init_vae(vcfg, seed=0, device=device, dtype=dtype)
    return dcfg, dit, vcfg, vae, dtype


def _timed(fn, device, reps: int = 3) -> dict:
    """ms per call by CUDA events over back-to-back calls (host gaps
    included), and the device time of the kernels it launches per call
    (torch.profiler, collectives included; None where the profiler
    recorded no kernel): where the first is far above the second the path
    is host-bound. Every rank calls ``fn`` the same number of times (it
    holds collectives)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    import chip_smoke

    if device.type != "cuda":
        return {}
    ms = chip_smoke.time_ms(fn, reps=reps, batches=3)
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return {"ms": ms, "device_ms": total_us / reps / 1e3 if total_us else None}


def check_sp(dcfg, params, dtype, device, tiny, world, tol):
    import numpy as np
    import torch

    from avatar_tpu_torch.models.dit import (
        dit_apply, permute_dit_params_for_split_rope, precompute_cross_attention_kv)
    from avatar_tpu_torch.ops.rope import get_latent_coords
    from avatar_tpu_torch.parallel import Mesh, dit_apply_sp

    import chip_smoke

    params = permute_dit_params_for_split_rope(params, dcfg)
    grid = (2, 4, 8 * world) if tiny else chip_smoke.LONG_GRID
    n = grid[0] * grid[1] * grid[2]
    g = torch.Generator(device=device).manual_seed(41)
    x = torch.randn(1, n, dcfg.in_channels, generator=g, device=device).to(dtype)
    coords = get_latent_coords(*grid, batch_size=1, device=device).float()
    embeds = torch.randn(1, 16, dcfg.caption_channels, generator=g, device=device).to(dtype)
    mask = torch.ones(1, 16, device=device)
    mask[0, 12:] = 0.0
    t = torch.tensor([0.7], device=device)
    kv, _ = precompute_cross_attention_kv(params, dcfg, embeds, dtype=dtype)
    common = dict(encoder_attention_mask=mask, cross_kv=kv, rope_split=True)
    mesh = Mesh(np.arange(world), ("sp",))
    out = {}
    with torch.no_grad():
        base = dit_apply(params, dcfg, x, coords, t, **common)
        out["unsharded"] = _timed(lambda: dit_apply(params, dcfg, x, coords, t, **common),
                                  device)
        for impl in ("ulysses", "ring"):
            def run():
                return dit_apply_sp(params, dcfg, x, coords, t, mesh=mesh, sp_impl=impl,
                                    **common)

            out[impl] = {"rel_rms": _rel(run(), base), **_timed(run, device)}
            out[impl]["ok"] = out[impl]["rel_rms"] <= tol
    return {"check": "sp", "tokens": n, **out}


def check_pp(dcfg, params, dtype, device, tiny, world, tol):
    import torch

    from avatar_tpu_torch.models.dit import dit_apply
    from avatar_tpu_torch.ops.rope import get_latent_coords
    from avatar_tpu_torch.parallel import dit_apply_pp, make_pp_mesh, stack_block_params
    from avatar_tpu_torch.parallel.collectives import chunk_of
    from avatar_tpu_torch.parallel.mesh import map_with_path

    grid = (2, 4, 4) if tiny else (13, 8, 8)
    n = grid[0] * grid[1] * grid[2]
    g = torch.Generator(device=device).manual_seed(43)
    b = world
    x = torch.randn(b, n, dcfg.in_channels, generator=g, device=device).to(dtype)
    coords = get_latent_coords(*grid, batch_size=b, device=device).float()
    embeds = torch.randn(b, 16, dcfg.caption_channels, generator=g, device=device).to(dtype)
    mask = torch.ones(b, 16, device=device)
    t = torch.rand(b, generator=g, device=device)
    mesh = make_pp_mesh(world)
    pg = mesh.group("pp")
    stage = dict(params, blocks=map_with_path(lambda _, v: chunk_of(v, pg, 0).contiguous(),
                                              stack_block_params(params["blocks"])))
    args = (x, coords, t, embeds, mask)
    with torch.no_grad():
        base = dit_apply(params, dcfg, *args, rope_split=False)

        def run():
            return dit_apply_pp(stage, dcfg, *args, mesh=mesh, num_microbatches=b)

        rel = _rel(run(), base)
        return {"check": "pp", "stages": world, "batch": b, "tokens": n, "rel_rms": rel,
                "ok": rel <= tol, **_timed(run, device),
                "unsharded": _timed(lambda: dit_apply(params, dcfg, *args, rope_split=False),
                                    device)}


def check_dp(dcfg, params, vcfg, vae, dtype, device, tiny, world, tol):
    import numpy as np
    import torch

    from avatar_tpu_torch.parallel import Mesh
    from avatar_tpu_torch.pipelines.pipeline import GenerationParams, LTXVideoPipeline

    size, frames = (64, 9) if tiny else (256, 97)
    p = GenerationParams(height=size, width=size, num_frames=frames, num_inference_steps=3,
                         guidance_scale=1.0, stg_scale=0.0, rescaling_scale=1.0)
    g = torch.Generator(device=device).manual_seed(45)
    embeds = torch.randn(world, 16, dcfg.caption_channels, generator=g, device=device)
    mask = torch.ones(world, 16, device=device)
    out = {}
    for name, ctor in (("unsharded", {}), ("dp", {"dp_mesh": Mesh(np.arange(world),
                                                                    ("data",))})):
        pipe = LTXVideoPipeline(dcfg, params, vcfg, vae, device=device, **ctor)
        for _ in range(2):  # the second call is timed (the first warms up)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            with torch.no_grad():
                out[name] = pipe(p, torch.Generator(device=device).manual_seed(5), embeds,
                                 mask, output_type="latent", dtype=dtype)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out[f"{name}_s"] = time.perf_counter() - t0
    rel = _rel(out["dp"], out["unsharded"])
    return {"check": "dp", "batch": world, "rel_rms": rel, "ok": rel <= tol,
            "seconds": out["dp_s"], "unsharded_seconds": out["unsharded_s"]}


def check_train(dcfg, params, device, tiny, world, loss_rtol, update_tol):
    import dataclasses

    import numpy as np
    import torch

    from avatar_tpu_torch.core.config import TrainConfig
    from avatar_tpu_torch.models.dit import permute_dit_params_for_split_rope
    from avatar_tpu_torch.parallel import Mesh, make_mesh, make_pp_mesh
    from avatar_tpu_torch.train import train as tt

    import chip_smoke

    f, h, w = (2, 4, 4) if tiny else chip_smoke.TRAIN_GRID
    batch_n = 2 * world if tiny else chip_smoke.TRAIN_BATCH
    g = torch.Generator(device=device).manual_seed(47)
    batch = {k: torch.randn(1, batch_n, n, h, w, dcfg.in_channels, generator=g,
                            device=device)
             for k, n in (("latents", f), ("pose_latents", f), ("ref_image_latents", 1))}
    embeds = torch.randn(1, 64, dcfg.caption_channels, generator=g, device=device)
    mask = torch.ones(1, 64, device=device)
    cfg = TrainConfig(checkpoint_path="-", train_mode="lora_audio", learning_rate=1e-4,
                      lora_rank=4 if tiny else 32, lora_alpha=4 if tiny else 32,
                      batch_size=batch_n, rf_log_normal_mu=-0.5, rf_log_normal_sigma=1.0)
    split = permute_dit_params_for_split_rope(params, dcfg)
    trainable0 = tt.init_trainable(params, dcfg, cfg,
                                   torch.Generator(device=device).manual_seed(3))
    if tiny:  # nonzero b, so that the first step's LoRA moves the output
        trainable0["lora"] = tt.tree_map(lambda x: x + 0.05, trainable0["lora"])

    def step(mode, mesh, run_cfg):
        opt = tt.make_optimizer(run_cfg)
        if mode is None:
            sharding, p, tr, state = None, split, trainable0, opt.init(trainable0)
            rows = batch
        else:
            sharding = tt.TrainSharding(mesh, mode, min_size=64 if tiny else None)
            p, tr = sharding.place(split, trainable0)
            state = sharding.init_optimizer(opt, tr)
            rows = {k: sharding.rows(v, 1) for k, v in batch.items()}
        fn = tt.make_train_step(dcfg, run_cfg, opt, rope_split=True, sharding=sharding)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        tr, state, metrics = fn(tr, state, p, rows, embeds, mask,
                                torch.Generator(device=device).manual_seed(9))
        loss = float(metrics["loss"])
        checked = tr if sharding is None else sharding.full_tree(tr)
        # a second step, timed (the first warms up); its result is not checked
        t0 = time.perf_counter()
        fn(tr, state, p, rows, embeds, mask, torch.Generator(device=device).manual_seed(9))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        tr = checked
        peak = (torch.cuda.max_memory_allocated(device) / 2**30
                if device.type == "cuda" else float("nan"))
        return loss, tr, seconds, peak

    ref_loss, ref_tr, ref_s, ref_peak = step(None, None, cfg)
    runs = {}
    modes = {"sp_ulysses": ("sp", "ulysses"), "sp_ring": ("sp", "ring"), "pp": ("pp", None),
             "zero2": ("zero2", None), "fsdp": ("fsdp", None)}
    for name, (mode, impl) in modes.items():
        mesh = (Mesh(np.arange(world).reshape(1, world), ("data", "sp")) if mode == "sp"
                else make_pp_mesh(world) if mode == "pp" else make_mesh(data=1, fsdp=world))
        run_cfg = cfg if impl is None else dataclasses.replace(cfg, sp_impl=impl)
        loss, tr, seconds, peak = step(mode, mesh, run_cfg)
        loss_rel = abs(loss - ref_loss) / abs(ref_loss)
        upd = chip_smoke._update_rel_rms(trainable0, tr, ref_tr)
        runs[name] = {"loss": loss, "loss_rel": loss_rel, "update_rel_rms": upd,
                      "seconds": seconds, "max_memory_allocated_gib": peak,
                      "ok": loss_rel <= loss_rtol and upd <= update_tol}
    return {"check": "train", "batch": batch_n, "ranks": world, "one_device_loss": ref_loss,
            "one_device_seconds": ref_s, "one_device_peak_gib": ref_peak, "runs": runs}


def _ok(row) -> bool:
    return all(v.get("ok", True) for v in row.values() if isinstance(v, dict)) and row.get(
        "ok", True)


def _worker(rank: int, world: int, port: int, device: str, tiny: bool, out: str) -> None:
    import torch

    from avatar_tpu_torch.parallel import initialize

    import chip_smoke

    if device == "cpu":
        torch.set_num_threads(1)
    initialize(f"localhost:{port}", world, rank, local_device_ids=[rank], device=device,
               timeout_s=600)
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    dcfg, params, vcfg, vae, dtype = _models(tiny, dev)
    tol = 1e-4 if tiny else chip_smoke.KERNEL_PATH_TOL
    train_tol = (1e-5, 1e-4) if tiny else (chip_smoke.TRAIN_LOSS_RTOL,
                                           chip_smoke.TRAIN_UPDATE_TOL)
    rows = [check_sp(dcfg, params, dtype, dev, tiny, world, tol),
            check_pp(dcfg, params, dtype, dev, tiny, world, tol),
            check_dp(dcfg, params, vcfg, vae, dtype, dev, tiny, world, tol),
            check_train(dcfg, params, dev, tiny, world, *train_tol)]
    if rank == 0:
        with open(out, "w") as fh:
            for row in rows:
                fh.write(json.dumps({**row, "ok": _ok(row)}) + "\n")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    import torch
    import torch.multiprocessing as mp

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--world", type=int, default=0, help="ranks (default: every card)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--tiny", action="store_true", help="a tiny f32 model")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("parallel_check: no CUDA device (use --device cpu --tiny)", file=sys.stderr)
        return 1
    world = args.world or (torch.cuda.device_count() if args.device == "cuda" else 2)
    sys.path.insert(0, os.getcwd())
    if args.device == "cuda":
        from avatar_tpu_torch.ops import kernel_build

        kernel_build.build_all(["flash_forward_sm90", "flash_backward_sm90",
                                "rope_attention_sm90", "token_attention_sm90",
                                "flash_forward"])
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "checks.jsonl")
        mp.start_processes(_worker, args=(world, port, args.device, args.tiny, out),
                           nprocs=world, start_method="spawn")
        with open(out) as fh:
            for line in fh:
                print(line.strip(), flush=True)
                ok = ok and json.loads(line)["ok"]
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip(), flush=True)
    print(json.dumps({"ok": ok, "world": world, "seconds": time.perf_counter() - t0}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
