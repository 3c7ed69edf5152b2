"""The port's W8A8 VAE against the JAX package's, on the CPU: the
quantized tree (``quantize_vae_params``) bit for bit, the plain int8
conv3d (kernel L's plain version) equal to the reference's
``conv3d_same`` with an int8 kernel in every padding, stride, kernel size,
dtype and non-finite case, the tiny quantized VAE's encode and decode, and
the pipeline's ``quantize_vae`` and the CLI's ``quantization_vae``.
The config is the JAX test's (``tests/test_extras.py::test_w8a8_vae``)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.cli import infer as jinfer
from avatar_tpu.models import dit as jdit
from avatar_tpu.models import vae as jvae
from avatar_tpu.utils import quantize as jquant
from avatar_tpu.utils import weight_import as jwi
from avatar_tpu_torch.cli import infer as tinfer
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.models import vae as tvae
from avatar_tpu_torch.ops import causal_conv3d as tconv
from avatar_tpu_torch.pipelines import pipeline as tpipe
from avatar_tpu_torch.utils import quantize as tquant
from avatar_tpu_torch.utils.weight_import import vae_params_from_numpy
from torch_parity import dit_numpy_params, vae_numpy_params

# avatar_tpu.ops re-exports the function under the module's name. It runs
# eagerly, as the JAX package's own test runs it: compiled whole, XLA on
# the CPU contracts the f32 epilogue's multiply and bias add into one
# fused multiply-add, one rounding fewer than the code spells out (and the
# port and kernel L do).
jconv_params = importlib.import_module("avatar_tpu.ops.causal_conv3d").conv3d_params

torch.set_num_threads(2)

CONFIG = {
    "latent_channels": 8, "base_channels": 32,
    "encoder_blocks": [["res_x", {"num_layers": 1}], ["compress_all", {"multiplier": 2}],
                       ["res_x", {"num_layers": 1}]],
    "decoder_blocks": [["res_x", {"num_layers": 1}],
                       ["compress_all", {"residual": True, "multiplier": 2}],
                       ["res_x", {"num_layers": 1}]],
    "norm_layer": "pixel_norm", "patch_size": 2, "latent_log_var": "uniform",
}
MIN_SIZE = 2**10
# The tiny quantized VAE in f32, port against JAX, as the relative RMS of
# the difference. Each int8 conv fed the same input gives the same output
# bit for bit (test_quantized_vae_convs_match_jax_on_the_same_inputs), but the
# port's f32 convolutions and norms sum in another order than XLA's, a ulp
# apart, and a level whose x / s lands within that ulp of a .5 boundary
# rounds the other way in one package. One flipped level moves that conv's
# output by 1e-4 relative, and the flips cascade through the convs that
# follow: 2.1e-3 at the encoder's output and 3.3e-4 at the decoder's
# measured, against int8's own distance from f32 of 1.5e-2 and 2.5e-2
# (and 5e-7 for the f32 VAE, port against JAX). The limit is 2.4x the
# larger reading, and 3x below int8's own distance from f32 at the encoder.
REL_RMS = 5e-3


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2)))


@pytest.fixture(scope="module")
def vaes():
    jcfg, tcfg = jvae.VAEConfig.from_dict(CONFIG), tvae.VAEConfig.from_dict(CONFIG)
    tree = vae_numpy_params(jcfg)
    jq = jquant.quantize_vae_params(jax.tree.map(jnp.asarray, tree), min_size=MIN_SIZE)
    tq = tquant.quantize_vae_params(vae_params_from_numpy(tree, tcfg, device="cpu"),
                                    min_size=MIN_SIZE)
    return jcfg, jq, tcfg, tq


def test_quantize_vae_params_match_jax_bit_for_bit(vaes):
    """The JAX tree quantized and carried across equals the port's own
    quantization of the carried f32 tree: levels, scales, biases and the
    leaves left in f32."""
    jcfg, jq, tcfg, tq = vaes
    carried = dict(_leaves(vae_params_from_numpy(jax.tree.map(np.asarray, jq), tcfg,
                                                 device="cpu")))
    own = dict(_leaves(tq))
    assert carried.keys() == own.keys()
    q_convs = [p for p in own if p.endswith("/kernel_q8")]
    assert len(q_convs) >= 10
    for path, v in own.items():
        assert v.dtype == carried[path].dtype, path
        assert torch.equal(v, carried[path]), path
    for path in q_convs:
        assert own[path].dtype == torch.int8 and own[path].ndim == 5
        assert own[path.replace("kernel_q8", "scale")].dtype == torch.float32
        assert path.replace("kernel_q8", "weight") not in own


# C_in, C_out, kernel size, stride, causal, spatial padding, dtype
CONV_CASES = [
    (8, 16, 3, 1, True, "zeros", "f32"),
    (33, 24, 3, 2, True, "replicate", "bf16"),
    (48, 40, 3, (2, 1, 1), False, "zeros", "bf16"),
    (40, 8, 3, (1, 2, 2), False, "replicate", "f32"),
    (16, 24, 1, 2, False, "zeros", "f32"),
]
# (the reference refuses replicate padding for a kernel without a spatial
# pad: conv3d_same raises)


def _conv_pair(rng, c, n, k, bias=True):
    w = (0.1 * rng.standard_normal((k, k, k, c, n))).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    jp = jquant.quantize_conv3d({"kernel": jnp.asarray(w), **({"bias": jnp.asarray(b)}
                                                               if bias else {})})
    tp = {"kernel_q8": tconv.int8_conv_layout(torch.from_numpy(
              np.asarray(jp["kernel_q8"]).transpose(4, 3, 0, 1, 2))),
          "scale": torch.from_numpy(np.array(jp["scale"]))}
    if bias:
        tp["bias"] = torch.from_numpy(b)
    return jp, tp


def _run_both(jp, tp, x, stride, causal, mode, dtype):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                       torch.float32)
    ref = jconv_params(jp, jnp.asarray(x).astype(jdt), stride=stride, causal=causal,
                       spatial_padding_mode=mode)
    out = tconv.conv3d_params(tp, torch.from_numpy(x).to(tdt).permute(0, 4, 1, 2, 3),
                              stride=stride, causal=causal, spatial_padding_mode=mode)
    assert out.dtype == tdt
    return out.float().permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("c,n,k,stride,causal,mode,dtype", CONV_CASES)
def test_int8_conv_plain_equals_jax(c, n, k, stride, causal, mode, dtype):
    """Kernel L's plain version equals the reference's int8 ``conv3d_same``
    (through its causal / non-causal time pad) exactly, in f32 and bf16."""
    rng = np.random.default_rng(c * 100 + n)
    jp, tp = _conv_pair(rng, c, n, k, bias=c != 40)
    x = rng.standard_normal((2, 5, 6, 7, c)).astype(np.float32)
    out, ref = _run_both(jp, tp, x, stride, causal, mode, dtype)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("kind", ["zeros", "nan"])
def test_int8_conv_plain_zero_and_nan_inputs_equal_jax(kind):
    """An all-zero input: no division by a zero scale, the bias comes out.
    A NaN: the scale and every output are NaN in both packages."""
    rng = np.random.default_rng(3)
    jp, tp = _conv_pair(rng, 8, 16, 3)
    x = np.zeros((1, 3, 6, 6, 8), np.float32)
    if kind == "nan":
        x = rng.standard_normal(x.shape).astype(np.float32)
        x[0, 1, 2, 3, 4] = np.nan
    out, ref = _run_both(jp, tp, x, 1, False, "replicate", "f32")
    np.testing.assert_array_equal(out, ref)
    if kind == "zeros":
        np.testing.assert_array_equal(out, np.broadcast_to(tp["bias"].numpy(), out.shape))
    else:
        assert np.isnan(out).all()


@pytest.fixture(scope="module")
def jax_runs(vaes):
    """The JAX package's quantized encode (of seeded media, with its own
    posterior draw) and decode (of those latents), each int8 conv recorded
    with its params, input, options and output."""
    jcfg, jq, _, _ = vaes
    seen = []
    jvae_module = importlib.import_module("avatar_tpu.models.vae")
    original = jvae_module.conv3d_params

    def record(params, x, **kw):
        y = original(params, x, **kw)
        if "kernel_q8" in params:
            seen.append((params, np.array(x), kw, np.array(y)))
        return y

    rng = np.random.default_rng(0)
    media = rng.uniform(-1, 1, (1, 9, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvae_module, "conv3d_params", record)
        latents = np.array(jvae.vae_encode(jq, jcfg, media, key=key))
        pixels = np.array(jvae.vae_decode(jq, jcfg, latents))
    noise = np.array(jax.random.normal(key, latents.shape, dtype=jnp.float32))
    return dict(media=media, noise=noise, latents=latents, pixels=pixels, convs=seen)


def test_quantized_vae_encode_decode_match_jax(vaes, jax_runs):
    """The tiny quantized VAE in f32: encode (the posterior noise is JAX's
    own draw) and decode, port against JAX (``REL_RMS``)."""
    _, _, tcfg, tq = vaes
    enc = tvae.vae_encode(tq, tcfg, torch.from_numpy(jax_runs["media"]),
                          noise=torch.from_numpy(jax_runs["noise"]))
    dec = tvae.vae_decode(tq, tcfg, torch.from_numpy(jax_runs["latents"]))
    assert enc.shape == jax_runs["latents"].shape
    assert dec.shape == jax_runs["pixels"].shape == (1, 9, 32, 32, 3)
    assert _rel_rms(enc.numpy(), jax_runs["latents"]) < REL_RMS
    assert _rel_rms(dec.numpy(), jax_runs["pixels"]) < REL_RMS
    # a zero latent divides by no zero scale
    assert torch.isfinite(tvae.vae_decode(tq, tcfg, torch.zeros_like(enc))).all()


def test_quantized_vae_convs_match_jax_on_the_same_inputs(vaes, jax_runs):
    """Every int8 conv of the JAX encode and decode, fed to the port's
    ``conv3d_params`` with its params carried across, gives the JAX
    output bit for bit."""
    tcfg = vaes[2]
    assert len(jax_runs["convs"]) >= 10
    for params, x, kw, y in jax_runs["convs"]:
        tp = vae_params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
        out = tconv.conv3d_params(tp, torch.from_numpy(x).permute(0, 4, 1, 2, 3), **kw)
        np.testing.assert_array_equal(out.permute(0, 2, 3, 4, 1).numpy(), y)


DIT_KW = dict(num_attention_heads=2, attention_head_dim=8, in_channels=8, out_channels=8,
              num_layers=1, cross_attention_dim=16, caption_channels=32)


def test_pipeline_quantize_vae_runs():
    """``quantize_vae`` ("w8a8", or any true value) gives the VAE
    ``quantize_vae_params``' tree, and a generation through it is finite."""
    dcfg = tdit.DiTConfig(**DIT_KW)
    vcfg = tvae.VAEConfig.from_dict(CONFIG)
    vae = tvae.init_vae(vcfg, seed=0, device="cpu")
    ref = dict(_leaves(tquant.quantize_vae_params(vae)))
    assert any(p.endswith("kernel_q8") for p in ref)
    for q in (True, "w8a8"):
        pipe = tpipe.LTXVideoPipeline(dcfg, tdit.init_dit(dcfg, seed=1, device="cpu"),
                                      vcfg, vae, quantize_vae=q, device="cpu")
        got = dict(_leaves(pipe.vae_params))
        assert got.keys() == ref.keys()
        assert all(torch.equal(got[p], v) for p, v in ref.items())
    out = pipe(tpipe.GenerationParams(height=32, width=32, num_frames=8,
                                      num_inference_steps=2, guidance_scale=1.0,
                                      stg_scale=0.0, rescaling_scale=1.0),
               torch.Generator().manual_seed(1), torch.randn(1, 8, 32),
               torch.ones(1, 8), dtype=torch.float32)
    assert out.shape == (1, 9, 32, 32, 3) and torch.isfinite(out).all()


def test_cli_quantization_vae_reaches_the_vae(tmp_path):
    """The yaml's ``quantization`` / ``quantization_vae`` reach the
    pipeline (``tests/test_cli.py::test_cli_end_to_end``'s check): the int8
    convs of the JAX CLI's VAE, carried across, are the port CLI's bit for
    bit, and its generation is finite."""
    jcfg = jvae.VAEConfig.from_dict(CONFIG)
    dcfg = jdit.DiTConfig(**DIT_KW)
    ckpt = tmp_path / "ckpt.safetensors"
    vtree = vae_numpy_params(jcfg)
    jwi.save_single_file_checkpoint(
        ckpt, dit_numpy_params(dcfg), dcfg,
        vae_state=jwi.export_vae_state(vtree, jcfg), vae_config=jcfg.to_dict(),
        scheduler_config={"_class_name": "RectifiedFlowScheduler", "sampler": "Uniform",
                          "shifting": "SD3", "target_shift_terminal": 0.1})
    pcfg = {"checkpoint_path": str(ckpt), "precision": "float32",
            "sampler": "from_checkpoint", "quantization": "w8a8",
            "quantization_vae": "w8a8"}
    pipe = tinfer.load_pipeline(pcfg, device="cpu")
    assert "kernel_q8" in pipe.raw_dit_params["blocks"][0]["ff"]["proj_in"]
    jpipe = jinfer.create_ltx_video_pipeline(
        str(ckpt), precision="float32", sampler="from_checkpoint", attention_impl="xla",
        quantize="w8a8", quantize_vae="w8a8")
    carried = dict(_leaves(vae_params_from_numpy(
        jax.tree.map(np.asarray, jpipe.vae_params), tvae.VAEConfig.from_dict(CONFIG),
        device="cpu")))
    got = dict(_leaves(pipe.vae_params))
    q_convs = [p for p in got if p.endswith("kernel_q8")]
    assert q_convs and carried.keys() == got.keys()
    assert all(torch.equal(got[p], carried[p]) for p in q_convs)
    assert all(torch.equal(got[p.replace("kernel_q8", "scale")],
                           carried[p.replace("kernel_q8", "scale")]) for p in q_convs)
    out = pipe(tpipe.GenerationParams(height=32, width=32, num_frames=8,
                                      num_inference_steps=2, guidance_scale=1.0,
                                      stg_scale=0.0, rescaling_scale=1.0,
                                      decode_timestep=0.05),
               torch.Generator().manual_seed(1), torch.randn(1, 8, 32),
               torch.ones(1, 8), dtype=torch.float32)
    assert torch.isfinite(out).all()
