"""Training CLI: LoRA / full fine-tuning of the avatar DiT on latent pairs,
and VAE-decoder fine-tuning (port of ``avatar_tpu/cli/train.py``), on one
device:

  python -m avatar_tpu_torch.cli.train --config configs/train-avatars.yaml \
      --train_mode lora_audio

Reads a single-file checkpoint, trains on the ``{stem}`` latent files of
the config's directories, validates after each epoch, exports a merged
single-file checkpoint every ``save_every_n_epochs`` (``best_`` prefix for
the best epoch loss so far, ``*_ema`` beside it with ``ema_decay``) and
keeps the resume state under ``<output_dir>/state``; a later call resumes
from its newest step. SIGTERM saves the resume state at the next step and
returns. ``--train_mode decoder`` (or ``decoder_train: true``) fine-tunes
the VAE decoder on ``{stem}_pixels.npy`` targets instead
(:func:`decoder_train_loop`). The prompt embeddings come from
``prompt_embeds_path``, else from the port's T5 encoder where its weights
and tokenizer are on disk, else are zeros (:func:`encode_train_prompt`).

Several processes, one per device, train together when launched with
``--coordinator host:port --num_processes N --process_id i`` (or a GPU
launcher's ``MASTER_ADDR`` / ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``):
every ``sharding_mode`` of the JAX package runs (``dp``, ``zero2`` and
``fsdp`` over ``mesh_data`` x ``mesh_fsdp``; ``sp`` over ``mesh_data`` x
the rest; ``pp`` over ``pp_stages`` and a data axis; ``train/train.py``),
each process loads only its rows of each batch, rank 0 logs and exports
(after gathering the sharded trees) and each rank keeps its own resume
state under ``state/rank_<i>``.
"""

from __future__ import annotations

import argparse
import signal
from pathlib import Path

import numpy as np
import torch

TRAIN_PROMPT = "Person speaking naturally, with natual face and body movements"


def encode_train_prompt(config, caption_channels: int = 4096, device="cuda"):
    """(embeds [1, L, caption_channels] f32, mask [1, L]) of the fixed
    training prompt, in the JAX CLI's order: the safetensors file
    ``config.prompt_embeds_path`` (``prompt_embeds``,
    ``prompt_attention_mask``); else the T5 encoder and tokenizer of
    ``text_encoder_model_name_or_path`` (a local directory; nothing is
    fetched); else 256 zero embeddings, all kept, with a message."""
    path = getattr(config, "prompt_embeds_path", None)
    if path:
        from avatar_tpu_torch.utils.safetensors_io import load_safetensors

        t, _ = load_safetensors(path)
        return (t["prompt_embeds"].float().to(device),
                t["prompt_attention_mask"].float().to(device))
    try:
        from avatar_tpu_torch.models.t5 import encode_prompt, load_t5_encoder

        model_path = getattr(config, "text_encoder_model_name_or_path",
                             "PixArt-alpha/PixArt-XL-2-1024-MS")
        t5_cfg, t5_params = load_t5_encoder(model_path, device=device)
        from transformers import T5TokenizerFast

        tokenizer = T5TokenizerFast.from_pretrained(model_path, subfolder="tokenizer",
                                                    local_files_only=True)
        embeds, mask = encode_prompt(t5_params, t5_cfg, tokenizer, TRAIN_PROMPT)
        return embeds.float(), mask
    except (OSError, ImportError) as e:  # no local T5 weights, tokenizer or transformers
        print(f"[train] T5 unavailable ({e}); using zero prompt embeddings")
        return (torch.zeros((1, 256, caption_channels), device=device),
                torch.ones((1, 256), device=device))


def decoder_train_loop(config, resume: bool = True, device="cuda"):
    """VAE-decoder fine-tuning (``train_mode="decoder"`` or
    ``decoder_train``; see ``train/decoder.py``) on ``{stem}_pixels.npy``
    uint8 targets beside the encoder latents, every one checked up front.
    Exports ``vae_epoch_{n}.safetensors`` (the checkpoint's DiT and the
    trained VAE) every ``save_every_n_epochs`` and keeps the resume state;
    returns the trainable decoder tree."""
    from avatar_tpu_torch.data.dataset import (
        LatentPairDataset, epoch_batches, prefetch_batches,
    )
    from avatar_tpu_torch.models.dit import DiTConfig
    from avatar_tpu_torch.models.vae import VAEConfig
    from avatar_tpu_torch.train.checkpoints import TrainStateCheckpointer
    from avatar_tpu_torch.train.decoder import (
        init_decoder_trainable, make_decoder_train_step, merge_decoder_trainable,
    )
    from avatar_tpu_torch.train.train import make_lr_schedule, make_optimizer
    from avatar_tpu_torch.utils.metrics import MetricsLogger
    from avatar_tpu_torch.utils.weight_import import (
        export_vae_state, import_transformer_state, import_vae_state,
        load_single_file_checkpoint, save_single_file_checkpoint,
    )

    from avatar_tpu_torch.parallel import process_count

    if process_count() > 1:
        # the reference's decoder loop is data-parallel over one process's
        # devices and ignores sharding_mode; one process per device here
        raise ValueError("decoder training runs in one process")
    configs, t_state, v_state = load_single_file_checkpoint(config.checkpoint_path)
    vae_cfg = VAEConfig.from_dict(configs["vae"])
    dtype = torch.bfloat16 if config.precision in ("bfloat16", "bf16") else None
    vae_params = import_vae_state(v_state, vae_cfg, device=device, dtype=dtype)
    del v_state

    dataset = LatentPairDataset(config.condition_latents_dir, config.encoder_latents_dir)
    # every stem up front: a batch mixing clips with and without pixels
    # would drop the key and fail mid-epoch
    missing = [s for s in dataset.items
               if not (dataset.encoder_dir / f"{s}_pixels.npy").exists()]
    if len(dataset) == 0 or missing:
        raise ValueError(
            "decoder training needs {stem}_pixels.npy pixel targets beside the "
            "encoder latents — rerun `cli.preprocess save-vae-latents --save_pixels`"
            + (f" (missing for {len(missing)}/{len(dataset)} clips, e.g. "
               f"{missing[:3]})" if missing else ""))
    steps_per_epoch = len(dataset) // (
        config.batch_size * config.gradient_accumulation_steps)
    total_steps = steps_per_epoch * (config.num_epochs or 0)
    lr_fn = make_lr_schedule(config, total_steps)

    trainable = init_decoder_trainable(vae_params)
    optimizer = make_optimizer(config, total_steps)
    opt_state = optimizer.init(trainable)
    step_fn = make_decoder_train_step(vae_cfg, config, optimizer)

    logger = MetricsLogger(
        output_dir=config.output_dir, wandb_project=config.wandb_project,
        wandb_run_name=config.wandb_run_name,
        wandb_config={"mode": "decoder", "batch_size": config.batch_size,
                      "learning_rate": config.learning_rate,
                      "decoder_t_max": config.decoder_t_max})
    if config.decoder_loss_lpips_weight:
        print("[train] decoder_loss_lpips_weight > 0 but lpips is not "
              "installed — LPIPS term skipped (L1 only)")

    checkpointer = None
    global_step = start_epoch = 0
    if config.output_dir:
        checkpointer = TrainStateCheckpointer(Path(config.output_dir) / "state")
        if resume and checkpointer.latest_step() is not None:
            global_step, restored = checkpointer.restore(device=device)
            trainable, opt_state = restored["trainable"], restored["opt_state"]
            start_epoch = int(restored["extra"].get("epoch", 0))
            print(f"[train] resumed decoder training from step {global_step}")

    def to_device(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)

    gen = torch.Generator(device=device).manual_seed(config.seed + 2)
    try:
        for epoch in range(start_epoch, config.num_epochs or 0):
            losses = []
            for batch in prefetch_batches(
                    epoch_batches(dataset, config.batch_size,
                                  config.gradient_accumulation_steps,
                                  seed=config.seed, epoch=epoch),
                    device_put=to_device):
                arrays = {k: batch[k] for k in ("latents", "pixels")}
                trainable, opt_state, metrics = step_fn(trainable, opt_state, vae_params,
                                                        arrays, gen)
                global_step += 1
                loss = float(metrics["loss"])
                losses.append(loss)
                if global_step % config.log_every_n_steps == 0:
                    logger.log(global_step, {
                        "train/decoder_loss": loss,
                        "train/decoder_l1": float(metrics["decoder_l1"]),
                        "train/decoder_psnr": float(metrics["decoder_psnr"]),
                        "train/epoch": epoch,
                        "train/lr": lr_fn(global_step) if callable(lr_fn) else lr_fn})
            epoch_loss = sum(losses) / len(losses) if losses else 0.0
            print(f"Decoder epoch {epoch + 1} finished. Average loss: {epoch_loss:.6f}")

            if config.output_dir and (epoch + 1) % config.save_every_n_epochs == 0:
                merged = merge_decoder_trainable(vae_params, trainable)
                dit_cfg = DiTConfig.from_dict(configs["transformer"])
                dit_params = import_transformer_state(t_state, dit_cfg, device="cpu")
                path = Path(config.output_dir) / f"vae_epoch_{epoch + 1}.safetensors"
                save_single_file_checkpoint(
                    path, dit_params, dit_cfg, vae_state=export_vae_state(merged, vae_cfg),
                    vae_config=configs["vae"], scheduler_config=configs.get("scheduler"))
                del dit_params
                print(f"[train] saved {path}")
                if checkpointer is not None:
                    checkpointer.save(global_step, trainable, opt_state,
                                      extra={"epoch": epoch + 1})
    finally:
        logger.finish()
    print("Decoder training complete!")
    return trainable


def train_loop(config, resume: bool = True, device="cuda"):
    """Train as ``config`` says; returns the trainable tree (this rank's
    share of it over a mesh)."""
    if config.decoder_train or config.train_mode == "decoder":
        return decoder_train_loop(config, resume=resume, device=device)
    from avatar_tpu_torch.data.dataset import (
        LatentPairDataset, epoch_batches, prefetch_batches,
    )
    from avatar_tpu_torch.models.dit import DiTConfig, permute_dit_params_for_split_rope
    from avatar_tpu_torch.train.checkpoints import (
        TrainStateCheckpointer, export_training_checkpoint,
    )
    from avatar_tpu_torch.parallel import (
        is_main_process, make_mesh, process_count, process_index, sync_processes,
    )
    from avatar_tpu_torch.parallel.mesh import Mesh
    from avatar_tpu_torch.parallel.pipeline import make_pp_mesh
    from avatar_tpu_torch.train.train import (
        TrainSharding, ema_params, init_trainable, make_lr_schedule, make_optimizer,
        make_train_step, tree_leaves, tree_map, validate_step_fn,
    )
    from avatar_tpu_torch.utils.metrics import MetricsLogger
    from avatar_tpu_torch.utils.weight_import import (
        import_transformer_state, load_single_file_checkpoint,
    )

    n_proc, pid = process_count(), process_index()
    main_proc = is_main_process()
    mode = config.sharding_mode
    sharding = None
    if mode == "sp":
        data = config.mesh_data if config.mesh_data > 0 else 1
        if n_proc % data or n_proc // data < 2:
            raise ValueError(f"sharding_mode=sp needs mesh_data ({data}) to divide the "
                             f"{n_proc} processes with an sp axis >= 2")
        sharding = TrainSharding(Mesh(np.arange(n_proc).reshape(data, n_proc // data),
                                      ("data", "sp")), "sp")
    elif mode == "pp":
        if config.train_mode != "lora_audio":
            raise ValueError("sharding_mode=pp supports train_mode lora_audio only")
        if n_proc % config.pp_stages or config.pp_stages < 2:
            raise ValueError(f"pp_stages={config.pp_stages} must be >=2 and divide the "
                             f"{n_proc} processes")
        sharding = TrainSharding(make_pp_mesh(config.pp_stages, n_proc // config.pp_stages),
                                 "pp")
    elif mode in ("dp", "zero2", "fsdp"):
        if n_proc > 1 or mode != "dp":
            sharding = TrainSharding(make_mesh(data=config.mesh_data, fsdp=config.mesh_fsdp),
                                     mode)
    else:
        raise ValueError(f"unknown sharding_mode {mode!r}")
    if sharding is not None and config.batch_size % sharding.batch_group.size:
        raise ValueError(f"batch_size {config.batch_size} not divisible by the "
                         f"{sharding.batch_group.size} ranks of the batch axes")
    rows_index = 0 if sharding is None else sharding.batch_group.index
    rows_count = 1 if sharding is None else sharding.batch_group.size

    # -- model --
    configs, t_state, _ = load_single_file_checkpoint(config.checkpoint_path)
    dit_cfg = DiTConfig.from_dict(configs["transformer"])
    dtype = torch.bfloat16 if config.precision in ("bfloat16", "bf16") else torch.float32
    dit_params = import_transformer_state(t_state, dit_cfg, device=device, dtype=dtype)
    del t_state
    # lora_audio trains in the split-RoPE layout, so that self-attention
    # takes the RoPE-fused kernel: the permutation touches only the frozen
    # attn1 q/k. The exports merge into the unpermuted tree, which shares
    # every other leaf, so they stay in the reference's layout.
    rope_split = config.train_mode == "lora_audio"
    run_params = (permute_dit_params_for_split_rope(dit_params, dit_cfg)
                  if rope_split else dit_params)

    # -- data (before the optimizer: a decaying schedule needs the horizon) --
    dataset = LatentPairDataset(config.condition_latents_dir, config.encoder_latents_dir)
    val_dataset = None
    if config.val_condition_latents_dir and config.val_encoder_latents_dir:
        val_dataset = LatentPairDataset(config.val_condition_latents_dir,
                                        config.val_encoder_latents_dir)
    if main_proc:
        print(f"[train] {len(dataset)} train clips"
              + (f", {len(val_dataset)} val clips" if val_dataset else "")
              + (f"; {n_proc} processes, sharding_mode={mode}" if n_proc > 1 else ""))
    steps_per_epoch = len(dataset) // (
        config.batch_size * config.gradient_accumulation_steps)
    total_steps = steps_per_epoch * (config.num_epochs or 0)
    lr_fn = make_lr_schedule(config, total_steps)

    optimizer = make_optimizer(config, total_steps)
    trainable = init_trainable(
        dit_params, dit_cfg, config,
        torch.Generator(device=device).manual_seed(config.seed))
    n_trainable = sum(t.numel() for t in tree_leaves(trainable))
    n_total = sum(t.numel() for t in tree_leaves(dit_params))
    if sharding is None:
        opt_state = optimizer.init(trainable)
    else:
        run_params, trainable = sharding.place(run_params, trainable)
        opt_state = sharding.init_optimizer(optimizer, trainable)
        if mode == "fsdp":
            # the device holds this rank's chunks; the unpermuted tree that
            # the exports merge into waits on the host
            dit_params = tree_map(lambda x: x.cpu(), dit_params)
    step_fn = make_train_step(dit_cfg, config, optimizer, rope_split=rope_split,
                              sharding=sharding)
    val_fn = validate_step_fn(dit_cfg, config, rope_split=rope_split, sharding=sharding)
    prompt_embeds, prompt_mask = encode_train_prompt(
        config, dit_cfg.caption_channels, device)

    # -- logging / checkpoints (rank 0 logs and exports) --
    if main_proc:
        print(f"[params] total={n_total} trainable={n_trainable}")
    logger = MetricsLogger(
        output_dir=config.output_dir if main_proc else None,
        wandb_project=config.wandb_project if main_proc else None,
        wandb_run_name=config.wandb_run_name,
        wandb_config={"batch_size": config.batch_size,
                      "learning_rate": config.learning_rate,
                      "num_epochs": config.num_epochs, "lora_rank": config.lora_rank,
                      "lora_alpha": config.lora_alpha,
                      "checkpoint_path": config.checkpoint_path,
                      "precision": config.precision})
    logger.set_summary(trainable_params=n_trainable, total_params=n_total)

    checkpointer = None
    global_step = start_epoch = 0
    if config.output_dir:
        state_dir = Path(config.output_dir) / "state"
        # each rank's share of the state (the same layout resumes it)
        checkpointer = TrainStateCheckpointer(
            state_dir / f"rank_{pid}" if n_proc > 1 else state_dir)
        if resume and checkpointer.latest_step() is not None:
            global_step, restored = checkpointer.restore(device=device)
            trainable, opt_state = restored["trainable"], restored["opt_state"]
            start_epoch = int(restored["extra"].get("epoch", 0))
            if main_proc:
                print(f"[train] resumed from step {global_step} (epoch {start_epoch})")

    # SIGTERM (a preemption notice): save the resume state at the next step
    # boundary and return, so that the next call resumes from that step
    preempted = {"flag": False}

    def on_sigterm(signum, frame):
        preempted["flag"] = True
        print("[train] SIGTERM received: checkpointing at the next step boundary")

    try:
        previous_handler = signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:  # not the main thread
        previous_handler = None

    def to_device(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)

    def lr_at(step):
        return lr_fn(step) if callable(lr_fn) else lr_fn

    best_loss = float("inf")
    gen = torch.Generator(device=device).manual_seed(config.seed + 1)
    try:
        for epoch in range(start_epoch, config.num_epochs or 0):
            losses = []
            for batch in prefetch_batches(
                    epoch_batches(dataset, config.batch_size,
                                  config.gradient_accumulation_steps,
                                  seed=config.seed, epoch=epoch,
                                  process_index=rows_index, process_count=rows_count),
                    device_put=to_device):
                arrays = {k: v for k, v in batch.items() if k != "stem"}
                trainable, opt_state, metrics = step_fn(
                    trainable, opt_state, run_params, arrays, prompt_embeds,
                    prompt_mask, gen)
                global_step += 1
                loss = float(metrics["loss"])
                losses.append(loss)
                if global_step % config.log_every_n_steps == 0:
                    logger.log(global_step, {
                        "train/loss": loss,
                        "train/rel_mse": float(metrics["rel_mse"]),
                        "train/nrmse": float(metrics["nrmse"]),
                        "train/transformer_mse": float(metrics["transformer_mse"]),
                        "train/epoch": epoch, "train/lr": lr_at(global_step)})
                if preempted["flag"]:
                    if checkpointer is not None:
                        checkpointer.save(global_step, trainable, opt_state,
                                          extra={"epoch": epoch})
                        if main_proc:
                            print(f"[train] preemption checkpoint at step {global_step}")
                    return trainable

            epoch_loss = sum(losses) / len(losses) if losses else 0.0
            logger.log(global_step, {"train/epoch_loss": epoch_loss})
            if main_proc:
                print(f"Epoch {epoch + 1} finished. Average loss: {epoch_loss:.6f}")

            if val_dataset is not None:
                val_losses = []
                val_gen = torch.Generator(device=device).manual_seed(epoch)
                for batch in epoch_batches(val_dataset, config.batch_size, 1, seed=0,
                                           epoch=0, shuffle=False,
                                           process_index=rows_index,
                                           process_count=rows_count):
                    micro = {k: to_device(v[0]) for k, v in batch.items() if k != "stem"}
                    m = val_fn(trainable, run_params, micro, prompt_embeds, prompt_mask,
                               val_gen)
                    val_losses.append(float(m["loss"]))
                if val_losses:
                    val_loss = sum(val_losses) / len(val_losses)
                    logger.log(global_step, {"val/loss": val_loss, "val/epoch": epoch})
                    if main_proc:
                        print(f"Validation epoch {epoch + 1}, loss: {val_loss:.6f}")

            if config.output_dir and (epoch + 1) % config.save_every_n_epochs == 0:
                is_best = epoch_loss < best_loss
                best_loss = min(best_loss, epoch_loss)
                meta = {"epoch": str(epoch + 1), "global_step": str(global_step)}
                out = Path(config.output_dir)
                # every rank joins the gathers; rank 0 writes the merged,
                # unstacked export
                host_trainable = (trainable if sharding is None
                                  else sharding.full_tree(trainable, held_as="trainable"))
                host_ema = None
                if config.ema_decay > 0:
                    host_ema = ema_params(opt_state)
                    if sharding is not None:
                        host_ema = sharding.full_tree(host_ema, held_as="state")
                if mode == "fsdp":
                    host_trainable = tree_map(lambda x: x.cpu(), host_trainable)
                    if host_ema is not None:
                        host_ema = tree_map(lambda x: x.cpu(), host_ema)
                if main_proc:
                    path = export_training_checkpoint(
                        out / f"model_epoch_{epoch + 1}.safetensors", dit_params, dit_cfg,
                        host_trainable, config, metadata=meta, is_best=is_best)
                    print(f"[train] saved {path}")
                    if host_ema is not None:
                        path = export_training_checkpoint(
                            out / f"model_epoch_{epoch + 1}_ema.safetensors", dit_params,
                            dit_cfg, host_ema, config,
                            metadata={**meta, "ema_decay": str(config.ema_decay)})
                        print(f"[train] saved {path}")
                sync_processes()
                checkpointer.save(global_step, trainable, opt_state,
                                  extra={"epoch": epoch + 1})
    finally:
        if previous_handler is not None:
            signal.signal(signal.SIGTERM, previous_handler)
        logger.finish()
    if main_proc:
        print("Training complete!")
    return trainable


def main(argv=None):
    parser = argparse.ArgumentParser(description="avatar_tpu_torch training")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--train_mode", type=str, choices=["full", "lora_audio", "decoder"],
                        default="full")
    parser.add_argument("--no_resume", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    # one process per device: the coordinator is process 0's host:port;
    # omitted, a launcher's MASTER_ADDR / RANK / WORLD_SIZE are read
    parser.add_argument("--coordinator", type=str, default=None,
                        help="coordinator address host:port (process 0)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    args = parser.parse_args(argv)

    from avatar_tpu_torch.core.config import load_train_config_from_yaml
    from avatar_tpu_torch.parallel import initialize

    initialize(coordinator_address=args.coordinator, num_processes=args.num_processes,
               process_id=args.process_id, device=args.device)

    config = load_train_config_from_yaml(args.config)
    config.train_mode = args.train_mode
    train_loop(config, resume=not args.no_resume, device=args.device)


if __name__ == "__main__":
    main()
