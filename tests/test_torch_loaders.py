"""The port's checkpoint loaders and pipeline constructor against the
JAX package's, on the CPU: the diffusers rename tables and
``normalize_diffusers_state``, ``load_checkpoint`` on a single-file
checkpoint the JAX package writes (equal trees, configs and scheduler),
and ``LTXVideoPipeline`` built with ``text_encoder=`` and the shared
arguments in the reference's positional order."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.models import dit as jdit
from avatar_tpu.models import vae as jvae
from avatar_tpu.pipelines import pipeline as jpipe
from avatar_tpu.utils import weight_import as jwi
from avatar_tpu_torch.diffusion.rf import RectifiedFlowSchedule as TSchedule
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.models import vae as tvae
from avatar_tpu_torch.pipelines import pipeline as tpipe
from avatar_tpu_torch.utils import weight_import as twi
from torch_parity import dit_numpy_params, vae_numpy_params

DIT_KW = dict(num_attention_heads=2, attention_head_dim=8, in_channels=8, out_channels=8,
              num_layers=2, cross_attention_dim=16, caption_channels=32)


def test_rename_tables_are_the_reference_s():
    assert list(twi.TRANSFORMER_KEYS_RENAME.items()) == list(jwi.TRANSFORMER_KEYS_RENAME.items())
    assert list(twi.VAE_KEYS_RENAME.items()) == list(jwi.VAE_KEYS_RENAME.items())


# every rule of both tables, and keys no rule touches
DIFFUSERS_KEYS = {
    "transformer": ["proj_in.weight", "time_embed.emb.timestep_embedder.linear_1.weight",
                    "transformer_blocks.3.attn1.norm_q.weight",
                    "transformer_blocks.3.attn2.norm_k.weight", "proj_out.bias",
                    "transformer_blocks.0.ff.net.0.proj.weight"],
    "vae": [f"{k}.conv.weight" for k in jwi.VAE_KEYS_RENAME if "." in k and k.startswith(
        ("encoder", "decoder"))] + [
        "decoder.up_blocks.2.resnets.1.conv_shortcut.conv.weight",
        "decoder.up_blocks.1.resnets.0.norm3.weight", "latents_mean", "latents_std",
        "encoder.conv_in.conv.weight", "decoder.timestep_scale_multiplier"],
}


@pytest.mark.parametrize("kind", sorted(DIFFUSERS_KEYS))
def test_normalize_diffusers_state_matches_jax(kind):
    rng = np.random.default_rng(len(kind))
    state = {k: rng.standard_normal(3).astype(np.float32) for k in DIFFUSERS_KEYS[kind]}
    ref = jwi.normalize_diffusers_state(state, kind)
    got = twi.normalize_diffusers_state({k: torch.from_numpy(v) for k, v in state.items()},
                                        kind)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    assert len(set(ref)) == len(state)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A single-file checkpoint written by the JAX package: a tiny DiT and
    VAE (per-channel statistics, timestep conditioning) and a scheduler."""
    jdcfg = jdit.DiTConfig(**DIT_KW)
    jvcfg = dataclasses.replace(jvae.demo_config(latent_channels=8), base_channels=32,
                                decoder_base_channels=32)
    dit = jax.tree.map(jnp.asarray, dit_numpy_params(jdcfg))
    vae = jax.tree.map(jnp.asarray, vae_numpy_params(jvcfg))
    path = tmp_path_factory.mktemp("loaders") / "ckpt.safetensors"
    jwi.save_single_file_checkpoint(
        path, dit, jdcfg, vae_state=jwi.export_vae_state(vae, jvcfg),
        vae_config=jvcfg.to_dict(),
        scheduler_config={"_class_name": "RectifiedFlowScheduler",
                          "num_train_timesteps": 1000, "sampler": "LinearQuadratic"})
    return path


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_load_checkpoint_matches_jax(checkpoint, dtype):
    jdcfg, jdit_p, jvcfg, jvae_p, jsched = jwi.load_checkpoint(checkpoint)
    tdcfg, tdit_p, tvcfg, tvae_p, tsched = twi.load_checkpoint(checkpoint, device="cpu",
                                                               dtype=dtype)
    assert tdcfg.to_dict() == jdcfg.to_dict() and tvcfg.to_dict() == jvcfg.to_dict()
    assert tsched == jsched and tsched["sampler"] == "LinearQuadratic"
    for got, ref in ((tdit_p, twi.dit_params_from_numpy(jax.tree.map(np.asarray, jdit_p),
                                                        tdcfg, device="cpu")),
                     (tvae_p, twi.vae_params_from_numpy(jax.tree.map(np.asarray, jvae_p),
                                                        tvcfg, device="cpu"))):
        got, ref = dict(_leaves(got)), dict(_leaves(ref))
        assert got.keys() == ref.keys()
        for k, r in ref.items():
            # the decoder's timestep multiplier, a scalar, stays f32
            scalar = k.endswith("timestep_scale_multiplier")
            want = r if dtype is None or scalar else r.to(dtype)
            assert got[k].dtype == want.dtype, k
            np.testing.assert_array_equal(got[k].float().numpy(), want.float().numpy(),
                                          err_msg=k)


def test_pipeline_takes_text_encoder_in_reference_order(checkpoint):
    """The arguments both constructors share, up to ``rope_split``, in the
    reference's positional order; ``text_encoder`` is kept as given and
    ``scan_blocks`` and ``device`` are keyword-only."""
    jdcfg, jdit_p, jvcfg, jvae_p, _ = jwi.load_checkpoint(checkpoint)
    tdcfg, tdit_p, tvcfg, tvae_p, _ = twi.load_checkpoint(checkpoint, device="cpu")
    encoder = object()
    allowed = [1.0, 0.5]
    shared = (encoder, 1, "xla", allowed, False, False, False)
    jp = jpipe.LTXVideoPipeline(jdcfg, jdit_p, jvcfg, jvae_p, None, *shared)
    tp = tpipe.LTXVideoPipeline(tdcfg, tdit_p, tvcfg, tvae_p, TSchedule.create(), *shared,
                                scan_blocks=True, device="cpu")
    for name in ("text_encoder", "patch_size", "attention_impl", "allowed_inference_steps",
                 "rope_split", "scan_blocks"):
        assert getattr(tp, name) == getattr(jp, name) if name != "scan_blocks" else (
            tp.scan_blocks is True), name
    assert tp.text_encoder is encoder and jp.text_encoder is encoder
    jnames = list(inspect.signature(jpipe.LTXVideoPipeline.__init__).parameters)
    params = inspect.signature(tpipe.LTXVideoPipeline.__init__).parameters
    positional = [n for n, p in params.items() if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert positional == jnames[:jnames.index("rope_split") + 1]
    assert {n for n, p in params.items() if p.kind == p.KEYWORD_ONLY} == {"scan_blocks",
                                                                          "device"}
    with pytest.raises(TypeError):
        tpipe.LTXVideoPipeline(tdcfg, tdit_p, tvcfg, tvae_p, None, *shared, True)
