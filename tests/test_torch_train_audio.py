"""The port's train step against the JAX package's on audio-conditioned
"lora_audio" batches (FaceFormer features in place of the prompt,
right-padded with a keep-mask) and with Adafactor in the "full" step, on
the CPU in f32, through ``tests/test_torch_train_options.py``'s tiny DiT
and step comparison."""

from test_torch_train_options import _run_both, params  # noqa: F401


def test_audio_latents_lora_step_matches_jax(params):
    """"lora_audio" on batches with audio latents and their keep-mask,
    which replace the prompt (zero-padded to the caption width)."""
    _run_both(params, "lora_audio", {}, audio=True)


def test_adafactor_full_step_matches_jax(params):
    """Adafactor in the "full" step, with clipping and the EMA (the tiny
    leaves are too small to factor; test_torch_adafactor.py holds the
    factored ones)."""
    _run_both(params, "full", dict(optimizer="adafactor", ema_decay=0.9))

