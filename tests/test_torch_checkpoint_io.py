"""Single-file checkpoints and the latent upsampler's file across the two
packages, on the CPU: what the JAX package writes (transformer and VAE
under their prefixes, configs in the metadata) the port reads into the
same trees as ``dit_params_from_numpy`` / ``vae_params_from_numpy`` /
``latent_upsampler_params_from_numpy`` make from the JAX params, bit for
bit; what the port writes reads back into the port and into the JAX
package unchanged."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from avatar_tpu.models import dit as jdit
from avatar_tpu.models import latent_upsampler as jup
from avatar_tpu.models import vae as jvae
from avatar_tpu.utils import safetensors_io as jst
from avatar_tpu.utils import weight_import as jwi
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.models import latent_upsampler as tup
from avatar_tpu_torch.models import vae as tvae
from avatar_tpu_torch.utils import weight_import as twi
from torch_parity import dit_numpy_params, vae_numpy_params

torch.set_num_threads(2)

DIT_KW = dict(num_attention_heads=2, attention_head_dim=8, in_channels=8, out_channels=8,
              num_layers=2, cross_attention_dim=16, caption_channels=32)
VAE_KINDS = {
    "demo": lambda: dataclasses.replace(jvae.demo_config(latent_channels=8),
                                        base_channels=16, decoder_base_channels=16),
    "variants": lambda: jvae.VAEConfig.from_dict(dict(
        latent_channels=8, encoder_base_channels=32, patch_size=4, norm_layer="group_norm",
        timestep_conditioning=True, normalize_latent_channels=True,
        encoder_blocks=[("res_x", {"num_layers": 1}), ("compress_all", {}),
                        ("res_x_y", {"multiplier": 2}), ("compress_all", {})],
        decoder_blocks=[("res_x", {"num_layers": 1, "inject_noise": True}),
                        ("compress_all", {"residual": True, "multiplier": 2}),
                        ("attn_res_x", {"num_layers": 2, "attention_head_dim": 64,
                                        "inject_noise": True}),
                        ("compress_all", {})])),
}


def _same_tree(a, b, path="root"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        assert torch.equal(a, b), path


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(VAE_KINDS))
def jax_checkpoint(request, tmp_path_factory):
    """A tiny DiT + VAE checkpoint as the JAX package writes it."""
    dcfg = jdit.DiTConfig(**DIT_KW)
    vcfg = VAE_KINDS[request.param]()
    dtree = dit_numpy_params(dcfg)
    vtree = vae_numpy_params(vcfg)
    path = tmp_path_factory.mktemp("ckpt") / f"{request.param}.safetensors"
    jwi.save_single_file_checkpoint(
        path, dtree, dcfg, vae_state=jwi.export_vae_state(vtree, vcfg),
        vae_config=vcfg.to_dict(),
        scheduler_config={"_class_name": "RectifiedFlowScheduler", "sampler": "Uniform"})
    return path, dcfg, dtree, vcfg, vtree


def test_port_reads_jax_checkpoint(jax_checkpoint):
    path, jdcfg, dtree, jvcfg, vtree = jax_checkpoint
    configs, t_state, v_state = twi.load_single_file_checkpoint(path)
    tdcfg = tdit.DiTConfig.from_dict(configs["transformer"])
    tvcfg = tvae.VAEConfig.from_dict(configs["vae"])
    assert tdcfg.to_dict() == jdcfg.to_dict()
    assert tvcfg.to_dict() == jvcfg.to_dict()
    assert configs["scheduler"]["sampler"] == "Uniform"
    _same_tree(twi.import_transformer_state(t_state, tdcfg, device="cpu"),
               twi.dit_params_from_numpy(dtree, tdcfg, device="cpu"))
    _same_tree(twi.import_vae_state(v_state, tvcfg, device="cpu"),
               twi.vae_params_from_numpy(vtree, tvcfg, device="cpu"))


def test_port_vae_export_round_trips(jax_checkpoint):
    """The port's export holds the keys the JAX export holds, reads back
    into the same port tree, and the JAX package reads the port's
    single-file checkpoint into the JAX tree it started from."""
    path, jdcfg, dtree, jvcfg, vtree = jax_checkpoint
    tvcfg = tvae.VAEConfig.from_dict(jvcfg.to_dict())
    tdcfg = tdit.DiTConfig.from_dict(jdcfg.to_dict())
    tparams = twi.vae_params_from_numpy(vtree, tvcfg, device="cpu")
    state = twi.export_vae_state(tparams, tvcfg)
    assert set(state) == set(jwi.export_vae_state(vtree, jvcfg))
    _same_tree(twi.import_vae_state(state, tvcfg, device="cpu"), tparams)

    out = path.with_name(f"port_{path.name}")
    twi.save_single_file_checkpoint(out, twi.dit_params_from_numpy(dtree, tdcfg, device="cpu"),
                                    tdcfg, vae_state=state, vae_config=tvcfg.to_dict())
    _, jt_state, jv_state = jwi.load_single_file_checkpoint(out)
    back = _numpy(jwi.import_vae_state(jv_state, jvcfg))
    jax.tree.map(np.testing.assert_array_equal, back, vtree)
    jax.tree.map(np.testing.assert_array_equal,
                 _numpy(jwi.import_transformer_state(jt_state, jdcfg)), dtree)


def test_import_vae_state_is_strict(jax_checkpoint):
    path, _, _, jvcfg, _ = jax_checkpoint
    _, _, v_state = twi.load_single_file_checkpoint(path)
    tvcfg = tvae.VAEConfig.from_dict(jvcfg.to_dict())
    with pytest.raises(ValueError, match="Unconsumed VAE checkpoint keys"):
        twi.import_vae_state(dict(v_state, stray=torch.zeros(1)), tvcfg, device="cpu")
    params = twi.import_vae_state(v_state, tvcfg, device="cpu", dtype=torch.bfloat16)
    assert params["encoder"]["conv_in"]["weight"].dtype == torch.bfloat16
    if tvcfg.timestep_conditioning:
        assert params["decoder"]["timestep_scale_multiplier"].dtype == torch.float32


@pytest.mark.parametrize("cfg", [
    jup.LatentUpsamplerConfig(in_channels=8, mid_channels=32, num_blocks_per_stage=1),
    jup.LatentUpsamplerConfig(in_channels=8, mid_channels=32, num_blocks_per_stage=2,
                              dims=2),
], ids=["dims3", "dims2"])
def test_latent_upsampler_file_loads_into_port(cfg, tmp_path):
    """A latent-upsampler safetensors in the reference's names and torch
    layouts (2-D convs stored [out, in, kh, kw]) with its config metadata:
    the port loads what ``latent_upsampler_params_from_numpy`` makes of the
    JAX package's load, and the port's export of it reads back."""
    rng = np.random.default_rng(3)
    jtree = _numpy(jup.init_latent_upsampler(jax.random.PRNGKey(0), cfg))
    state = {}

    def put_conv(key, p):
        w = p["kernel"]  # [kt, kh, kw, in, out]
        w = w[0].transpose(3, 2, 0, 1) if w.shape[0] == 1 else w.transpose(4, 3, 0, 1, 2)
        state[f"{key}.weight"] = np.ascontiguousarray(w)
        state[f"{key}.bias"] = p["bias"]

    def put_norm(key, p):
        state[f"{key}.weight"] = p["scale"] + 0.1 * rng.standard_normal(p["scale"].shape,
                                                                        np.float32)
        state[f"{key}.bias"] = p["bias"] + 0.1 * rng.standard_normal(p["bias"].shape,
                                                                     np.float32)

    put_conv("initial_conv", jtree["initial_conv"])
    put_norm("initial_norm", jtree["initial_norm"])
    for prefix, blocks in (("res_blocks", jtree["res_blocks"]),
                           ("post_upsample_res_blocks", jtree["post_res_blocks"])):
        for i, blk in enumerate(blocks):
            for n in ("1", "2"):
                put_conv(f"{prefix}.{i}.conv{n}", blk[f"conv{n}"])
                put_norm(f"{prefix}.{i}.norm{n}", blk[f"norm{n}"])
    put_conv("upsampler.0", jtree["upsampler_conv"])
    put_conv("final_conv", jtree["final_conv"])
    path = tmp_path / "upsampler.safetensors"
    jst.save_safetensors(state, path, metadata={"config": json.dumps(cfg.to_dict())})

    jcfg, jparams = jup.load_latent_upsampler(str(path))
    tcfg, tparams = tup.load_latent_upsampler(str(path), device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.to_dict() == jcfg.to_dict()
    _same_tree(tparams, twi.latent_upsampler_params_from_numpy(_numpy(jparams),
                                                               device="cpu"))
    _same_tree(tup.import_latent_upsampler_state(tup.export_latent_upsampler_state(tparams),
                                                 tcfg, device="cpu"), tparams)
