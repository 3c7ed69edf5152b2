"""Typed training config, YAML-compatible with the JAX package's
``configs/train-avatars.yaml`` (port of ``avatar_tpu/core/config.py``).

The fields are the JAX package's, so one YAML file configures both
trainers; the port's trainer (``cli/train.py``) runs ``sharding_mode="dp"``
on one device and raises on the other modes.
PyYAML is imported only by :func:`load_train_config_from_yaml`: a machine
without it can still build a :class:`TrainConfig` in code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class TrainConfig:
    checkpoint_path: str
    condition_latents_dir: Optional[str] = None
    encoder_latents_dir: Optional[str] = None
    val_condition_latents_dir: Optional[str] = None
    val_encoder_latents_dir: Optional[str] = None
    videos: Optional[str] = None

    output_dir: Optional[str] = None

    batch_size: Optional[int] = None
    num_epochs: Optional[int] = None
    learning_rate: Optional[float] = None

    lora_rank: int = 8
    lora_alpha: int = 8

    precision: str = "bfloat16"

    gradient_checkpointing: bool = False
    # Rematerialization when gradient_checkpointing is on: "full" keeps only
    # block inputs and recomputes each block in the backward; "dots" also
    # keeps the outputs of the weight products (every linear projection)
    # and recomputes the rest of the block
    remat_policy: str = "full"
    gradient_accumulation_steps: int = 1

    # "adamw" (torch AdamW's defaults: betas 0.9 / 0.999, eps 1e-8, weight
    # decay 0.01, with optax's update); "adafactor" (optax.adafactor's
    # defaults: a factored second moment, no first moment)
    optimizer: str = "adamw"
    # AdamW first-moment dtype, "float32" or "bfloat16" (the second moment
    # stays f32)
    optimizer_moment_dtype: str = "float32"

    # Off by default:
    #   max_grad_norm   — > 0 clips the gradients to this global norm
    #   lr_schedule     — "constant" | "cosine" | "linear" decay after warmup;
    #                     a decay needs a horizon: lr_total_steps or (in the
    #                     CLI) num_epochs x steps per epoch
    #   lr_warmup_steps — linear warmup 0 -> learning_rate
    #   ema_decay       — > 0 keeps an exponential moving average of the
    #                     trainable params in the optimizer state (with a
    #                     bias-corrected warmup), exported beside each epoch
    #                     checkpoint as *_ema.safetensors
    max_grad_norm: float = 0.0
    lr_schedule: str = "constant"
    lr_warmup_steps: int = 0
    lr_total_steps: int = 0
    ema_decay: float = 0.0

    # Parallelism: "dp" (data parallel; on one device the port's only
    # mode), "zero2", "fsdp", "pp" (pipeline stages) and "sp" (token axis
    # sharded) are the JAX package's
    sharding_mode: str = "dp"
    mesh_data: int = -1  # -1: all devices on the data axis
    mesh_fsdp: int = 1
    pp_stages: int = 1  # pipeline stages when sharding_mode == "pp"
    pp_microbatches: int = 0  # 0: auto (min(batch, stages))
    sp_impl: str = "ulysses"  # "ulysses" | "ring" (sharding_mode == "sp")

    # RF scheduler params
    rf_num_train_timesteps: int = 1000
    rf_sampler: str = "Uniform"
    rf_shift: Optional[float] = None
    rf_shifting: Optional[str] = None
    rf_base_resolution: int = 32 * 32
    rf_target_shift_terminal: Optional[float] = None
    rf_log_normal_mu: Optional[float] = None
    rf_log_normal_sigma: Optional[float] = None
    rf_quantile_min: float = 0.005
    rf_quantile_max: float = 0.999

    # Logging
    wandb_project: str = "ltx-video-avatars"
    wandb_run_name: Optional[str] = None
    log_every_n_steps: int = 10
    save_every_n_epochs: int = 1

    # VAE-decoder fine-tuning (train/decoder.py): train_mode "decoder" or
    # decoder_train, pixel targets {stem}_pixels.npy beside the latents
    decoder_train: bool = False
    transformer_loss_weight: float = 1.0
    decoder_loss_l1_weight: float = 0.1
    decoder_loss_lpips_weight: float = 0.0
    decoder_t_max: float = 0.1

    train_mode: str = "full"  # "full" | "lora_audio" | "decoder"
    seed: int = 0


def load_train_config_from_yaml(yaml_path: str) -> TrainConfig:
    """The JAX package's loader: top-level checkpoint_path, precision and
    sampler plus a ``train:`` block."""
    try:
        import yaml
    except ImportError as e:  # pragma: no cover - depends on the machine
        raise ImportError(
            "load_train_config_from_yaml needs PyYAML; without it, build a "
            "TrainConfig in code") from e
    with open(yaml_path, "r") as f:
        cfg = yaml.safe_load(f)

    checkpoint_path = cfg.get("checkpoint_path")
    if not checkpoint_path:
        raise ValueError("checkpoint_path is required in YAML for training.")

    sampler = cfg.get("sampler")
    rf_sampler = "Uniform"
    if isinstance(sampler, str):
        s = sampler.lower()
        if s in ("linear-quadratic", "linearquadratic"):
            rf_sampler = "LinearQuadratic"

    t = cfg.get("train", {}) or {}

    def opt_float(key):
        return float(t[key]) if t.get(key) is not None else None

    use_deepspeed = bool(t.get("use_deepspeed", False))
    sharding_mode = t.get("sharding_mode")
    if sharding_mode is None:
        # DeepSpeed config mapping: zero2/zero3 json -> sharding modes
        if use_deepspeed:
            ds = str(t.get("deepspeed_config", ""))
            sharding_mode = "fsdp" if "zero3" in ds else "zero2"
        else:
            sharding_mode = "dp"

    return TrainConfig(
        checkpoint_path=checkpoint_path,
        precision=cfg.get("precision", "bfloat16"),
        condition_latents_dir=t.get("condition_latents_dir"),
        encoder_latents_dir=t.get("encoder_latents_dir"),
        val_condition_latents_dir=t.get("val_condition_latents_dir"),
        val_encoder_latents_dir=t.get("val_encoder_latents_dir"),
        videos=t.get("videos"),
        output_dir=t.get("output_dir"),
        batch_size=int(t["batch_size"]) if "batch_size" in t else None,
        num_epochs=int(t["num_epochs"]) if "num_epochs" in t else None,
        learning_rate=opt_float("learning_rate"),
        lora_rank=int(t.get("lora_rank", 8)),
        lora_alpha=int(t.get("lora_alpha", 8)),
        gradient_checkpointing=bool(t.get("gradient_checkpointing", False)),
        remat_policy=str(t.get("remat_policy", "full")),
        gradient_accumulation_steps=int(t.get("gradient_accumulation_steps", 1)),
        optimizer=str(t.get("optimizer", "adamw")),
        optimizer_moment_dtype=str(t.get("optimizer_moment_dtype", "float32")),
        max_grad_norm=float(t.get("max_grad_norm", 0.0)),
        lr_schedule=str(t.get("lr_schedule", "constant")),
        lr_warmup_steps=int(t.get("lr_warmup_steps", 0)),
        lr_total_steps=int(t.get("lr_total_steps", 0)),
        ema_decay=float(t.get("ema_decay", 0.0)),
        sharding_mode=sharding_mode,
        mesh_data=int(t.get("mesh_data", -1)),
        mesh_fsdp=int(t.get("mesh_fsdp", 1)),
        pp_stages=int(t.get("pp_stages", 1)),
        pp_microbatches=int(t.get("pp_microbatches", 0)),
        sp_impl=str(t.get("sp_impl", "ulysses")),
        rf_sampler=t.get("rf_sampler", rf_sampler),
        rf_num_train_timesteps=int(t.get("rf_num_train_timesteps", 1000)),
        rf_shift=opt_float("rf_shift"),
        rf_shifting=t.get("rf_shifting"),
        rf_base_resolution=int(t.get("rf_base_resolution", 32 * 32)),
        rf_target_shift_terminal=opt_float("rf_target_shift_terminal"),
        rf_log_normal_mu=opt_float("rf_log_normal_mu"),
        rf_log_normal_sigma=opt_float("rf_log_normal_sigma"),
        rf_quantile_min=float(t.get("rf_quantile_min", 0.005)),
        rf_quantile_max=float(t.get("rf_quantile_max", 0.999)),
        wandb_project=t.get("wandb_project", "ltx-video-avatars"),
        wandb_run_name=t.get("wandb_run_name"),
        log_every_n_steps=int(t.get("log_every_n_steps", 10)),
        save_every_n_epochs=int(t.get("save_every_n_epochs", 1)),
        decoder_train=bool(t.get("decoder_train", False)),
        transformer_loss_weight=float(t.get("transformer_loss_weight", 1.0)),
        decoder_loss_l1_weight=float(t.get("decoder_loss_l1_weight", 0.1)),
        decoder_loss_lpips_weight=float(t.get("decoder_loss_lpips_weight", 0.0)),
        decoder_t_max=float(t.get("decoder_t_max", 0.1)),
        train_mode=t.get("train_mode", "full"),
        seed=int(t.get("seed", 0)),
    )
