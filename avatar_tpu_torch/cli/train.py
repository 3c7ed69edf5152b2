"""Training CLI: LoRA / full fine-tuning of the avatar DiT on latent pairs
(port of ``avatar_tpu/cli/train.py``), on one device:

  python -m avatar_tpu_torch.cli.train --config configs/train-avatars.yaml \
      --train_mode lora_audio

Reads a single-file checkpoint, trains on the ``{stem}`` latent files of
the config's directories, validates after each epoch, exports a merged
single-file checkpoint every ``save_every_n_epochs`` (``best_`` prefix for
the best epoch loss so far, ``*_ema`` beside it with ``ema_decay``) and
keeps the resume state under ``<output_dir>/state``; a later call resumes
from its newest step. SIGTERM saves the resume state at the next step and
returns. ``sharding_mode="dp"`` on one device only; decoder training is
not ported. The T5 encoder is not ported either: the prompt embeddings
come from ``prompt_embeds_path`` (a safetensors file with
``prompt_embeds`` and ``prompt_attention_mask``) or are zeros.
"""

from __future__ import annotations

import argparse
import signal
from pathlib import Path

import numpy as np
import torch


def encode_train_prompt(config, caption_channels: int = 4096, device="cuda"):
    """(embeds [1, L, caption_channels] f32, mask [1, L]) of the fixed
    training prompt: from ``config.prompt_embeds_path`` where set, else 256
    zero embeddings, all kept."""
    path = getattr(config, "prompt_embeds_path", None)
    if path:
        from avatar_tpu_torch.utils.safetensors_io import load_safetensors

        t, _ = load_safetensors(path)
        return (t["prompt_embeds"].float().to(device),
                t["prompt_attention_mask"].float().to(device))
    print("[train] no prompt_embeds_path and no T5 encoder in this package; "
          "using zero prompt embeddings")
    return (torch.zeros((1, 256, caption_channels), device=device),
            torch.ones((1, 256), device=device))


def train_loop(config, resume: bool = True, device="cuda"):
    """Train as ``config`` says; returns the trainable tree."""
    from avatar_tpu_torch.data.dataset import (
        LatentPairDataset, epoch_batches, prefetch_batches,
    )
    from avatar_tpu_torch.models.dit import DiTConfig, permute_dit_params_for_split_rope
    from avatar_tpu_torch.train.checkpoints import (
        TrainStateCheckpointer, export_training_checkpoint,
    )
    from avatar_tpu_torch.train.train import (
        ema_params, init_trainable, make_lr_schedule, make_optimizer,
        make_train_step, tree_leaves, validate_step_fn,
    )
    from avatar_tpu_torch.utils.metrics import MetricsLogger
    from avatar_tpu_torch.utils.weight_import import (
        import_transformer_state, load_single_file_checkpoint,
    )

    if config.decoder_train or config.train_mode == "decoder":
        raise NotImplementedError("decoder training is not ported")
    if config.sharding_mode != "dp":
        raise NotImplementedError(
            f"sharding_mode={config.sharding_mode!r} is not ported (one device, 'dp')")

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
    print(f"[train] {len(dataset)} train clips"
          + (f", {len(val_dataset)} val clips" if val_dataset else ""))
    steps_per_epoch = len(dataset) // (
        config.batch_size * config.gradient_accumulation_steps)
    total_steps = steps_per_epoch * (config.num_epochs or 0)
    lr_fn = make_lr_schedule(config, total_steps)

    optimizer = make_optimizer(config, total_steps)
    trainable = init_trainable(
        dit_params, dit_cfg, config,
        torch.Generator(device=device).manual_seed(config.seed))
    opt_state = optimizer.init(trainable)
    step_fn = make_train_step(dit_cfg, config, optimizer, rope_split=rope_split)
    val_fn = validate_step_fn(dit_cfg, config, rope_split=rope_split)
    prompt_embeds, prompt_mask = encode_train_prompt(
        config, dit_cfg.caption_channels, device)

    # -- logging / checkpoints --
    n_trainable = sum(t.numel() for t in tree_leaves(trainable))
    n_total = sum(t.numel() for t in tree_leaves(dit_params))
    print(f"[params] total={n_total} trainable={n_trainable}")
    logger = MetricsLogger(
        output_dir=config.output_dir, wandb_project=config.wandb_project,
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
        checkpointer = TrainStateCheckpointer(Path(config.output_dir) / "state")
        if resume and checkpointer.latest_step() is not None:
            global_step, restored = checkpointer.restore(device=device)
            trainable, opt_state = restored["trainable"], restored["opt_state"]
            start_epoch = int(restored["extra"].get("epoch", 0))
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
                                  seed=config.seed, epoch=epoch),
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
                        print(f"[train] preemption checkpoint at step {global_step}")
                    return trainable

            epoch_loss = sum(losses) / len(losses) if losses else 0.0
            logger.log(global_step, {"train/epoch_loss": epoch_loss})
            print(f"Epoch {epoch + 1} finished. Average loss: {epoch_loss:.6f}")

            if val_dataset is not None:
                val_losses = []
                val_gen = torch.Generator(device=device).manual_seed(epoch)
                for batch in epoch_batches(val_dataset, config.batch_size, 1, seed=0,
                                           epoch=0, shuffle=False):
                    micro = {k: to_device(v[0]) for k, v in batch.items() if k != "stem"}
                    m = val_fn(trainable, run_params, micro, prompt_embeds, prompt_mask,
                               val_gen)
                    val_losses.append(float(m["loss"]))
                if val_losses:
                    val_loss = sum(val_losses) / len(val_losses)
                    logger.log(global_step, {"val/loss": val_loss, "val/epoch": epoch})
                    print(f"Validation epoch {epoch + 1}, loss: {val_loss:.6f}")

            if config.output_dir and (epoch + 1) % config.save_every_n_epochs == 0:
                is_best = epoch_loss < best_loss
                best_loss = min(best_loss, epoch_loss)
                meta = {"epoch": str(epoch + 1), "global_step": str(global_step)}
                out = Path(config.output_dir)
                path = export_training_checkpoint(
                    out / f"model_epoch_{epoch + 1}.safetensors", dit_params, dit_cfg,
                    trainable, config, metadata=meta, is_best=is_best)
                print(f"[train] saved {path}")
                if config.ema_decay > 0:
                    path = export_training_checkpoint(
                        out / f"model_epoch_{epoch + 1}_ema.safetensors", dit_params,
                        dit_cfg, ema_params(opt_state), config,
                        metadata={**meta, "ema_decay": str(config.ema_decay)})
                    print(f"[train] saved {path}")
                checkpointer.save(global_step, trainable, opt_state,
                                  extra={"epoch": epoch + 1})
    finally:
        if previous_handler is not None:
            signal.signal(signal.SIGTERM, previous_handler)
        logger.finish()
    print("Training complete!")
    return trainable


def main(argv=None):
    parser = argparse.ArgumentParser(description="avatar_tpu_torch training")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--train_mode", type=str, choices=["full", "lora_audio"],
                        default="full")
    parser.add_argument("--no_resume", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from avatar_tpu_torch.core.config import load_train_config_from_yaml

    config = load_train_config_from_yaml(args.config)
    config.train_mode = args.train_mode
    train_loop(config, resume=not args.no_resume, device=args.device)


if __name__ == "__main__":
    main()
