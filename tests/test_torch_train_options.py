"""The port's remat "dots" (``dots_with_no_batch_dims_saveable``) against
the JAX package's, on the CPU in f32: the train step under "dots" against
the JAX "dots" step and against no remat, and what the backward
recomputes (``tests/test_torch_train_audio.py`` holds audio-conditioned
batches and Adafactor in the step).

The tiny DiT is ``test_torch_train.py``'s (heads of 16, 128 tokens), and
the port's step is fed the t and noise that the JAX step draws from its
key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from avatar_tpu.core.config import TrainConfig as JConfig
from avatar_tpu.models import dit as jdit
from avatar_tpu.train import train as jtrain
from avatar_tpu_torch.core.config import TrainConfig as TConfig
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.models.patchifier import patchify as tpatchify
from avatar_tpu_torch.train import train as ttrain
from avatar_tpu_torch.utils.weight_import import _convert, dit_params_from_numpy
from torch_parity import dit_numpy_params

torch.set_num_threads(2)

DIT_KW = dict(num_attention_heads=2, attention_head_dim=16, in_channels=8, out_channels=8,
              num_layers=2, cross_attention_dim=32, caption_channels=24)
JDIT, TDIT = jdit.DiTConfig(**DIT_KW), tdit.DiTConfig(**DIT_KW)
ACCUM, MICRO_B, FRAMES, HW, CAPTION = 2, 2, 2, 8, 128
N_TOKENS = FRAMES * HW * HW
AUDIO_T, AUDIO_D = 20, 16
# f32 on both sides, as test_torch_train.py's step comparison (two steps of
# the optimizer on gradients whose summation orders differ by ~1e-6)
TREE_ATOL = 2e-5
LOSS_RTOL = 1e-5
# test_torch_train.py's step settings (clipping to 0.05 and cosine decay,
# where its tolerance was set): Adam's first steps move an element by about
# lr whatever its gradient, so a gradient near 0 carries the routes' ~1e-6
# summation differences into the update
BASE = dict(checkpoint_path="x", learning_rate=1e-3, lora_rank=4, lora_alpha=8,
            rf_log_normal_mu=-0.5, rf_log_normal_sigma=1.0,
            gradient_accumulation_steps=ACCUM, batch_size=MICRO_B, max_grad_norm=0.05,
            lr_schedule="cosine", lr_total_steps=3)


@pytest.fixture(scope="module")
def params():
    tree = dit_numpy_params(JDIT)
    return jax.tree.map(jnp.asarray, tree), dit_params_from_numpy(tree, TDIT, device="cpu")


def _draws(key):
    ts, noises = [], []
    for i in range(ACCUM):
        k_t, k_noise = jax.random.split(jax.random.fold_in(key, i))
        ts.append(np.asarray(jtrain.sample_rf_timesteps(k_t, MICRO_B, -0.5, 1.0,
                                                        0.005, 0.999)))
        noises.append(np.asarray(jax.random.normal(k_noise, (MICRO_B, N_TOKENS, 8))))
    return torch.from_numpy(np.stack(ts)), torch.from_numpy(np.stack(noises))


def _batch(audio: bool):
    rng = np.random.default_rng(0)
    batch = {k: rng.standard_normal((ACCUM, MICRO_B, f, HW, HW, 8)).astype(np.float32)
             for k, f in (("latents", FRAMES), ("pose_latents", FRAMES),
                          ("ref_image_latents", 1))}
    if audio:
        # right-padded as collate_latent_pairs pads: each micro-batch's
        # second clip is shorter than its first
        batch["audio_latents"] = rng.standard_normal(
            (ACCUM, MICRO_B, AUDIO_T, AUDIO_D)).astype(np.float32)
        mask = np.ones((ACCUM, MICRO_B, AUDIO_T), np.float32)
        mask[:, 1, 14:] = 0.0
        batch["audio_latents"] *= mask[..., None]
        batch["audio_mask"] = mask
    embeds = rng.standard_normal((1, CAPTION, DIT_KW["caption_channels"])).astype(np.float32)
    mask = np.ones((1, CAPTION), np.float32)
    mask[0, 100:] = 0.0
    return batch, embeds, mask


def _to_port(tree):
    return _convert(jax.tree.map(np.asarray, tree), "cpu", torch.float32)


def _run_both(params, mode, cfg_kw, audio=False, steps=2, jax_side=True):
    """``steps`` optimizer steps of both packages' train steps (the port's
    alone without ``jax_side``) from the same trainable tree; asserts the
    losses and trees after each and returns the port's final trainable
    tree."""
    jparams, tparams = params
    jcfg, tcfg = JConfig(train_mode=mode, **BASE, **cfg_kw), TConfig(
        train_mode=mode, **BASE, **cfg_kw)
    split = mode == "lora_audio"
    if split:
        jp = jdit.permute_dit_params_for_split_rope(jparams, JDIT)
        tp = tdit.permute_dit_params_for_split_rope(tparams, TDIT)
        rng = np.random.default_rng(3)
        jtr = {"lora": jax.tree.map(
            lambda x: jnp.asarray((0.1 * rng.standard_normal(x.shape)).astype(np.float32)),
            jtrain.init_lora(jax.random.PRNGKey(1), JDIT, 4)),
            "caption_projection": jparams["caption_projection"]}
        ttr = {"lora": ttrain.tree_map(lambda x: torch.from_numpy(np.array(x)), jtr["lora"]),
               "caption_projection": tparams["caption_projection"]}
    else:
        jp, tp = jparams, tparams
        jtr = jtrain.split_full_trainable(jparams)
        ttr = ttrain.split_full_trainable(tparams)
    jtr = jax.tree.map(jnp.array, jtr)
    jopt, topt = jtrain.make_optimizer(jcfg), ttrain.make_optimizer(tcfg)
    jstate, tstate = jopt.init(jtr), topt.init(ttr)
    jstep = jtrain.make_train_step(JDIT, jcfg, jopt, rope_split=split)
    tstep = ttrain.make_train_step(TDIT, tcfg, topt, rope_split=split)
    batch, embeds, mask = _batch(audio)
    for step in range(steps):
        key = jax.random.PRNGKey(10 + step)
        t, noise = _draws(key)
        ttr, tstate, tm = tstep(ttr, tstate, tp,
                                {k: torch.from_numpy(v) for k, v in batch.items()},
                                torch.from_numpy(embeds), torch.from_numpy(mask),
                                t=t, noise=noise)
        if not jax_side:
            continue
        jtr, jstate, jm = jstep(jtr, jstate, jp, jax.tree.map(jnp.asarray, batch),
                                jnp.asarray(embeds), jnp.asarray(mask), key)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        ref = ({"lora": ttrain.tree_map(lambda x: torch.from_numpy(np.array(x)), jtr["lora"]),
                "caption_projection": _to_port(jtr["caption_projection"])}
               if split else _to_port(jtr))
        ttrain.tree_map(lambda a, b: np.testing.assert_allclose(
            a.numpy(), b.numpy(), atol=TREE_ATOL), ttr, ref)
    return ttr


DOTS = dict(gradient_checkpointing=True, remat_policy="dots")


@pytest.mark.parametrize("mode", ["lora_audio", "full"])
def test_dots_step_matches_jax_and_no_remat(params, mode):
    """Two steps under remat "dots" against the JAX "dots" step; the port's
    "dots" trees equal its no-remat ones bit for bit (the same ops, only
    what is kept differs)."""
    dots = _run_both(params, mode, DOTS)
    plain = _run_both(params, mode, {}, jax_side=False)
    ttrain.tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b.numpy()),
                    dots, plain)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_dots_keeps_the_products(params):
    """The backward under "dots" recomputes no 2-D product (every linear
    projection's output was kept), under "full" every one; the batched
    products of the plain attention are recomputed under both."""
    _, tparams = params
    rng = np.random.default_rng(2)
    tokens, coords = tpatchify(torch.from_numpy(
        rng.standard_normal((2, FRAMES, HW, HW, 8)).astype(np.float32)))
    embeds = torch.from_numpy(rng.standard_normal((2, CAPTION, 24)).astype(np.float32))
    counts = {}
    for remat in (False, "full", "dots"):
        weights = [b["ff"]["proj_in"]["weight"].clone().requires_grad_()
                   for b in tparams["blocks"]]
        p = dict(tparams, blocks=[dict(b, ff=dict(b["ff"], proj_in=dict(
            b["ff"]["proj_in"], weight=w))) for b, w in zip(tparams["blocks"], weights)])
        out = tdit.dit_apply(p, TDIT, tokens, coords, torch.tensor([0.3, 0.6]), embeds,
                             attention_impl="xla", rope_split=False, remat=remat)
        with _OpCount() as c:
            torch.autograd.grad(out.square().sum(), weights)
        counts[remat] = c.n
    # a block's linears: attn1's q, k, v and out, attn2's q and out (its k
    # and v come precomputed from the caption), the FF's in and out
    linears = 8 * DIT_KW["num_layers"]
    assert counts["full"].get("addmm", 0) == counts[False].get("addmm", 0) + linears
    assert counts["dots"].get("addmm", 0) == counts[False].get("addmm", 0)
    assert counts["dots"]["bmm"] == counts["full"]["bmm"] > counts[False]["bmm"]
