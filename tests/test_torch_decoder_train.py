"""The port's VAE-decoder fine-tuning against the JAX package's, on the CPU
in f32: ``decoder_loss``, the step with gradient accumulation and remat,
the merge, and the decoder's remat with noise injection
(``tests/test_torch_decoder_cli.py`` holds the CLI's decoder loop).

The tiny VAE is ``tests/test_decoder_train.py``'s (``demo_config`` at
latent width 8, 32 base channels: 2 x 2 x 2 latents decode to 9 frames of
64 x 64). jax.random's draws cannot be made in torch, so the port is fed
the t and noise that the JAX loss draws from its key.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.core.config import TrainConfig as JConfig
from avatar_tpu.models import vae as jvae
from avatar_tpu.train import decoder as jdec
from avatar_tpu.train import train as jtrain
from avatar_tpu_torch.core.config import TrainConfig as TConfig
from avatar_tpu_torch.models import vae as tvae
from avatar_tpu_torch.train import decoder as tdec
from avatar_tpu_torch.train import train as ttrain
from avatar_tpu_torch.utils.weight_import import _convert, vae_params_from_numpy
from torch_parity import vae_numpy_params

torch.set_num_threads(2)

LATENT_CH = 8
JVCFG = dataclasses.replace(jvae.demo_config(latent_channels=LATENT_CH), base_channels=32,
                            decoder_base_channels=32)
TVCFG = dataclasses.replace(tvae.demo_config(latent_channels=LATENT_CH), base_channels=32,
                            decoder_base_channels=32)
B, ACCUM, PIX = 2, 2, (9, 64, 64, 3)
# f32 decodes of the same weights: the conv summation orders (XLA's and
# torch's) differ by ~1e-6 relative; the L1 loss and PSNR carry that
LOSS_RTOL = 1e-5
# two AdamW steps on gradients that agree to ~1e-6: as the DiT step's
# (test_torch_train.py), within about lr x 2e-2 per element
TREE_ATOL = 2e-5
CFG = dict(checkpoint_path="x", learning_rate=1e-3, batch_size=B, train_mode="decoder",
           decoder_train=True, decoder_t_max=0.1, decoder_loss_l1_weight=0.1,
           max_grad_norm=0.05, lr_schedule="cosine", lr_total_steps=3)


@pytest.fixture(scope="module")
def vae():
    tree = vae_numpy_params(JVCFG)
    rng = np.random.default_rng(0)
    tree["per_channel_statistics"] = {
        "std_of_means": rng.uniform(0.5, 2, LATENT_CH).astype(np.float32),
        "mean_of_means": rng.normal(size=LATENT_CH).astype(np.float32)}
    return jax.tree.map(jnp.asarray, tree), vae_params_from_numpy(tree, TVCFG, device="cpu")


def _batch(accum=ACCUM):
    rng = np.random.default_rng(5)
    return {"latents": rng.standard_normal((accum, B, 2, 2, 2, LATENT_CH)).astype(np.float32),
            "pixels": rng.integers(0, 256, (accum, B) + PIX, dtype=np.uint8)}


def _draws(key, shape):
    k_t, k_noise = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(k_t, (shape[0],), jnp.float32))),
            torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32))))


def _to_port(tree):
    return _convert(jax.tree.map(np.asarray, tree), "cpu", torch.float32)


@pytest.mark.parametrize("remat", [False, True])
def test_decoder_loss_matches_jax(vae, remat):
    jparams, tparams = vae
    micro = {k: v[0] for k, v in _batch().items()}
    key = jax.random.PRNGKey(3)
    jcfg = JConfig(**CFG)
    jl, jm = jax.jit(lambda tr, p, b, k: jdec.decoder_loss(tr, p, JVCFG, jcfg, b, k, remat))(
        jdec.init_decoder_trainable(jparams), jparams, jax.tree.map(jnp.asarray, micro), key)
    t, noise = _draws(key, micro["latents"].shape)
    tl, tm = tdec.decoder_loss(tdec.init_decoder_trainable(tparams), tparams, TVCFG,
                               TConfig(**CFG), {k: torch.from_numpy(v) for k, v in
                                                micro.items()},
                               remat=remat, t=t, noise=noise)
    for name in ("loss", "decoder_l1", "decoder_psnr"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=LOSS_RTOL)


def test_decoder_step_matches_jax(vae):
    """Two steps with accumulation 2 and remat, clipping, cosine decay: the
    trained decoder after each, and the merge in the base dtype."""
    jparams, tparams = vae
    jcfg = JConfig(**CFG, gradient_accumulation_steps=ACCUM, gradient_checkpointing=True)
    tcfg = TConfig(**CFG, gradient_accumulation_steps=ACCUM, gradient_checkpointing=True)
    jopt, topt = jtrain.make_optimizer(jcfg), ttrain.make_optimizer(tcfg)
    jtr, ttr = jdec.init_decoder_trainable(jparams), tdec.init_decoder_trainable(tparams)
    jstate, tstate = jopt.init(jtr), topt.init(ttr)
    jstep = jdec.make_decoder_train_step(JVCFG, jcfg, jopt)
    tstep = tdec.make_decoder_train_step(TVCFG, tcfg, topt)
    batch = _batch()
    for step in range(2):
        key = jax.random.PRNGKey(20 + step)
        draws = [_draws(jax.random.fold_in(key, i), batch["latents"].shape[1:])
                 for i in range(ACCUM)]
        jtr, jstate, jm = jstep(jtr, jstate, jparams, jax.tree.map(jnp.asarray, batch), key)
        ttr, tstate, tm = tstep(ttr, tstate, tparams,
                                {k: torch.from_numpy(v) for k, v in batch.items()},
                                t=torch.stack([d[0] for d in draws]),
                                noise=torch.stack([d[1] for d in draws]))
        for name in ("loss", "decoder_l1", "decoder_psnr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=LOSS_RTOL)
        ttrain.tree_map(lambda a, b: np.testing.assert_allclose(
            a.numpy(), b.numpy(), atol=TREE_ATOL), ttr, _to_port(jtr))
    merged = tdec.merge_decoder_trainable(
        ttrain.tree_map(lambda x: x.to(torch.bfloat16), tparams), ttr)
    assert ttrain.tree_leaves(merged["decoder"])[0].dtype == torch.bfloat16
    assert merged["encoder"] is not None


def test_decoder_remat_noise_replays(vae):
    """Under remat a decoder with noise injection recomputes each block with
    the draws of its first run: the gradients equal those without remat."""
    _, tparams = vae
    cfg = dataclasses.replace(TVCFG, decoder_blocks=tuple(
        (name, dict(p, inject_noise=True) if name == "res_x" else p)
        for name, p in TVCFG.decoder_blocks))
    params = tvae.init_vae(cfg, 3, device="cpu")
    lat = torch.randn(1, 2, 2, 2, LATENT_CH, generator=torch.Generator().manual_seed(1))
    grads = []
    for remat in (False, True):
        leaves = [x.clone().requires_grad_() for x in ttrain.tree_leaves(params["decoder"])]
        p = dict(params, decoder=ttrain.tree_unflatten(params["decoder"], leaves))
        out = tvae.vae_decode(p, cfg, lat, timestep=torch.tensor([0.05]),
                              generator=torch.Generator().manual_seed(4), remat=remat)
        grads.append(torch.autograd.grad(out.square().sum(), leaves, allow_unused=True))
    for a, b in zip(*grads):
        assert (a is None and b is None) or torch.equal(a, b)
