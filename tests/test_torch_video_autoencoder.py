"""The port's legacy VideoAutoencoder and its convs against the JAX
package's, on the CPU in f32: ``conv3d_same``, ``linear_nd`` and
``dual_conv3d`` over strides, kernel sizes and padding modes (replicate
refused where the kernel has no spatial pad, in both), the encoder and
decoder at ``dims`` 3 and (2, 1), with channel padding and on a single
frame, and the state-dict import. Weights are random from seeds, carried
across by ``video_autoencoder_params_from_numpy``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.models import video_autoencoder as jva
from avatar_tpu.ops.causal_conv3d import conv3d_same as jconv3d_same
from avatar_tpu.ops.causal_conv3d import linear_nd as jlinear_nd
from avatar_tpu.ops.dual_conv3d import dual_conv3d as jdual_conv3d
from avatar_tpu_torch.models import video_autoencoder as tva
from avatar_tpu_torch.ops.causal_conv3d import conv3d_same, linear_nd
from avatar_tpu_torch.ops.dual_conv3d import dual_conv3d
from avatar_tpu_torch.utils.weight_import import video_autoencoder_params_from_numpy

torch.set_num_threads(2)

# f32 on both sides; XLA's and cuDNN's / oneDNN's conv summation orders
# differ by a few ulps a layer
REL_TOL = 1e-5
CONV_ATOL = 2e-5


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))


def _ndhwc(t):
    return t.permute(0, 2, 3, 4, 1).numpy()


def _weights(rng, cin, cout, kt, kh, kw):
    w = (0.2 * rng.standard_normal((kt, kh, kw, cin, cout))).astype(np.float32)
    return w, torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))


@pytest.mark.parametrize("k,stride,mode,tpad", [
    (3, 1, "zeros", (1, 1)), (3, 2, "zeros", (0, 0)), (3, (1, 2, 2), "replicate", (1, 1)),
    (3, (2, 1, 1), "replicate", (0, 1)), (1, 1, "zeros", (0, 0)), (1, 2, "constant", (1, 0)),
    (1, 1, "replicate", (0, 0)), (3, 1, "reflect", (0, 0)),
])
def test_conv3d_same_matches_jax(k, stride, mode, tpad):
    rng = np.random.default_rng(k * 10 + len(mode))
    x = rng.standard_normal((2, 5, 7, 6, 4)).astype(np.float32)
    w, tw = _weights(rng, 4, 6, k, k, k)
    b = rng.standard_normal(6).astype(np.float32)
    if mode == "reflect" or (mode == "replicate" and k == 1):
        for call in (lambda: jconv3d_same(jnp.asarray(x), jnp.asarray(w), stride=stride,
                                          spatial_padding_mode=mode),
                     lambda: conv3d_same(_ncdhw(x), tw, stride=stride,
                                         spatial_padding_mode=mode)):
            with pytest.raises(ValueError, match="padding mode"):
                call()
        return
    ref = np.asarray(jconv3d_same(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                                  spatial_padding_mode=mode, temporal_padding=tpad))
    out = _ndhwc(conv3d_same(_ncdhw(x), tw, torch.from_numpy(b), stride=stride,
                             spatial_padding_mode=mode, temporal_padding=tpad))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=CONV_ATOL)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_nd_matches_jax(bias):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 5, 6)).astype(np.float32)
    w = rng.standard_normal((6, 7)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32) if bias else None
    ref = np.asarray(jlinear_nd(jnp.asarray(x), jnp.asarray(w),
                                None if b is None else jnp.asarray(b)))
    out = _ndhwc(linear_nd(_ncdhw(x), torch.from_numpy(w.T.copy()),
                           None if b is None else torch.from_numpy(b)))
    np.testing.assert_allclose(out, ref, atol=CONV_ATOL)


@pytest.mark.parametrize("stride,mode", [((1, 1, 1), "zeros"), ((2, 1, 1), "zeros"),
                                         ((1, 2, 2), "zeros"), ((2, 2, 2), "constant"),
                                         ((1, 1, 1), "replicate")])
def test_dual_conv3d_matches_jax(stride, mode):
    rng = np.random.default_rng(sum(stride))
    x = rng.standard_normal((1, 5, 8, 6, 4)).astype(np.float32)
    ws, tws = _weights(rng, 4, 6, 1, 3, 3)
    wt, twt = _weights(rng, 6, 5, 3, 1, 1)
    bs, bt = (rng.standard_normal(n).astype(np.float32) for n in (6, 5))
    args = dict(stride=stride, padding_mode=mode)
    if mode == "replicate":
        # the temporal conv has no spatial pad: conv3d_same refuses it
        with pytest.raises(ValueError):
            jdual_conv3d(jnp.asarray(x), jnp.asarray(ws), jnp.asarray(wt), **args)
        with pytest.raises(ValueError):
            dual_conv3d(_ncdhw(x), tws, twt, **args)
        return
    ref = np.asarray(jdual_conv3d(jnp.asarray(x), jnp.asarray(ws), jnp.asarray(wt),
                                  jnp.asarray(bs), jnp.asarray(bt), **args))
    out = _ndhwc(dual_conv3d(_ncdhw(x), tws, twt, torch.from_numpy(bs),
                             torch.from_numpy(bt), **args))
    np.testing.assert_allclose(out, ref, atol=CONV_ATOL)


# tests/test_video_autoencoder.py's configs
DIMS3 = jva.VideoAutoencoderConfig(latent_channels=4, block_out_channels=(8, 16),
                                   layers_per_block=1, norm_layer="pixel_norm", patch_size=2,
                                   patch_size_t=1, latent_log_var="per_channel",
                                   use_quant_conv=True)
DICT21 = dict(_class_name="VideoAutoencoder", dims=[2, 1], latent_channels=8,
              block_out_channels=[32, 64], in_channels=3, out_channels=3, patch_size=2,
              norm_layer="group_norm", latent_log_var="per_channel", use_quant_conv=True)
CASES = {
    "dims3": (DIMS3, (1, 4, 16, 16, 3)),
    "dims3_frame": (DIMS3, (1, 1, 16, 16, 3)),
    "dims21": (dict(DICT21), (1, 4, 16, 16, 3)),
    "dims21_frame_padded": (dict(DICT21, add_channel_padding=True), (1, 1, 16, 16, 3)),
    "dims3_padded_uniform": (dict(DICT21, dims=3, add_channel_padding=True,
                                  latent_log_var="uniform", use_quant_conv=False),
                             (1, 4, 16, 16, 3)),
}


def _cfgs(cfg):
    if isinstance(cfg, dict):
        return jva.VideoAutoencoderConfig.from_dict(cfg), tva.VideoAutoencoderConfig.from_dict(cfg)
    return cfg, tva.VideoAutoencoderConfig(**{f: getattr(cfg, f)
                                              for f in cfg.__dataclass_fields__})


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_tree(node):
    """The port's tree in the JAX layout (the inverse of
    ``video_autoencoder_params_from_numpy``): weights [out, in, kt, kh, kw]
    become kernels [kt, kh, kw, in, out], linear weights [out, in] kernels
    [in, out]."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k == "weight":
                w = v.numpy()
                out["kernel"] = jnp.asarray(w.transpose(2, 3, 4, 1, 0) if w.ndim == 5 else w.T)
            else:
                out[k] = _jax_tree(v)
        return out
    if isinstance(node, (list, tuple)):
        return [_jax_tree(v) for v in node]
    return jnp.asarray(node.numpy())


def _params(tcfg, seed):
    """Random params from the port's init (the JAX init draws 1,024 keys
    eagerly, tens of seconds here), in both layouts."""
    tparams = tva.init_video_autoencoder(tcfg, seed=seed, device="cpu")
    if "scale" in tparams["encoder"]["conv_norm_out"]:
        g = torch.Generator().manual_seed(seed)
        for norm in (tparams["encoder"]["conv_norm_out"], tparams["decoder"]["conv_norm_out"]):
            norm["scale"] += 0.1 * torch.randn(norm["scale"].shape, generator=g)
            norm["bias"] += 0.1 * torch.randn(norm["bias"].shape, generator=g)
    return tparams, _jax_tree(tparams)


def test_params_from_numpy_inverts_the_jax_layout():
    for cfg in (DIMS3, dict(DICT21)):
        tparams, jparams = _params(_cfgs(cfg)[1], 4)
        back = dict(_leaves(video_autoencoder_params_from_numpy(_np_tree(jparams),
                                                                device="cpu")))
        for k, v in _leaves(tparams):
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_encoder_decoder_match_jax(case):
    cfg, shape = CASES[case]
    jcfg, tcfg = _cfgs(cfg)
    assert tcfg.spatial_downscale_factor == jcfg.spatial_downscale_factor
    tparams, jparams = _params(tcfg, 0)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    moments = np.asarray(jva.video_encoder_apply(jparams, jcfg, jnp.asarray(x)))
    got = tva.video_encoder_apply(tparams, tcfg, torch.from_numpy(x)).numpy()
    assert got.shape == moments.shape
    assert _rel_rms(got, moments) < REL_TOL
    in_time = shape[1] != 1
    lat = moments[..., :jcfg.latent_channels]
    rec = np.asarray(jva.video_decoder_apply(jparams, jcfg, jnp.asarray(lat),
                                             upsample_in_time=in_time))
    trec = tva.video_decoder_apply(tparams, tcfg, torch.from_numpy(lat),
                                   upsample_in_time=in_time).numpy()
    assert trec.shape == rec.shape == shape
    assert _rel_rms(trec, rec) < REL_TOL


def test_config_from_dict_matches_jax():
    for cfg in (DICT21, dict(DICT21, dims=3, double_z=False), dict(DICT21, patch_size_t=1)):
        j, t = _cfgs(cfg)
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == {
            f: getattr(j, f) for f in j.__dataclass_fields__}
    with pytest.raises(ValueError, match="dims"):
        tva.VideoAutoencoderConfig.from_dict(dict(DICT21, dims=[1, 2]))


def _torch_state(params):
    """A torch-layout state dict of a JAX tree (tests/test_video_autoencoder.py's
    inverse transforms, DualConv3d pairs as weight1 / weight2)."""
    state = {}

    def put_conv(key, p):
        if "spatial" in p:
            for i, part in ((1, "spatial"), (2, "temporal")):
                state[f"{key}.weight{i}"] = np.asarray(p[part]["kernel"]).transpose(4, 3, 0, 1, 2)
                state[f"{key}.bias{i}"] = np.asarray(p[part]["bias"])
            return
        state[f"{key}.weight"] = np.asarray(p["kernel"]).transpose(4, 3, 0, 1, 2)
        if "bias" in p:
            state[f"{key}.bias"] = np.asarray(p["bias"])

    def put_lin(key, p):
        state[f"{key}.weight"] = np.asarray(p["kernel"]).T[:, :, None, None, None]
        if "bias" in p:
            state[f"{key}.bias"] = np.asarray(p["bias"])

    def put_norm(key, p):
        if p:
            state[f"{key}.weight"] = np.asarray(p["scale"])
            state[f"{key}.bias"] = np.asarray(p["bias"])

    def put_resnet(prefix, p):
        for name in ("norm1", "norm2"):
            put_norm(f"{prefix}.{name}", p[name])
        for conv in ("conv1", "conv2"):
            put_conv(f"{prefix}.{conv}", p[conv])
        if "conv_shortcut" in p:
            put_lin(f"{prefix}.conv_shortcut", p["conv_shortcut"])

    for side, blocks, sample in (("encoder", "down_blocks", "downsample"),
                                 ("decoder", "up_blocks", "upsample")):
        c = params[side]
        put_conv(f"{side}.conv_in", c["conv_in"])
        put_conv(f"{side}.conv_out", c["conv_out"])
        put_norm(f"{side}.conv_norm_out", c["conv_norm_out"])
        for j, rb in enumerate(c["mid_block"]):
            put_resnet(f"{side}.mid_block.res_blocks.{j}", rb)
        for i, block in enumerate(c[blocks]):
            for j, rb in enumerate(block["res_blocks"]):
                put_resnet(f"{side}.{blocks}.{i}.res_blocks.{j}", rb)
            if sample in block:
                put_conv(f"{side}.{blocks}.{i}.{sample}.conv", block[sample])
    put_lin("quant_conv", params["quant_conv"])
    put_lin("post_quant_conv", params["post_quant_conv"])
    state["per_channel_statistics.std-of-means"] = np.full(
        params["post_quant_conv"]["kernel"].shape[0], 2.0, np.float32)
    return state


@pytest.mark.parametrize("case", ["dims3", "dims21"])
def test_state_import_matches_jax(case):
    """The same torch state dict through both importers: equal trees
    (with the reference's lookups: at dims (2, 1) a DualConv3d down- or
    upsampler, keyed ``.conv.weight1``, is not read by either) and equal
    encodes."""
    cfg, shape = CASES[case]
    jcfg, tcfg = _cfgs(cfg)
    state = _torch_state(_params(tcfg, 2)[1])
    jparams = jva.import_video_autoencoder_state(state, jcfg)
    tparams = tva.import_video_autoencoder_state(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}, tcfg,
        device="cpu")
    ref = video_autoencoder_params_from_numpy(_np_tree(jparams), device="cpu")
    flat_t = dict(_leaves(tparams))
    flat_r = dict(_leaves(ref))
    assert flat_t.keys() == flat_r.keys()
    for k in flat_r:
        np.testing.assert_array_equal(flat_t[k].numpy(), flat_r[k].numpy(), err_msg=k)
    assert "mean_of_means" in tparams["per_channel_statistics"]
    x = np.random.default_rng(3).standard_normal((1, 2, 8, 8, 3)).astype(np.float32)
    a = np.asarray(jva.video_encoder_apply(jparams, jcfg, jnp.asarray(x)))
    b = tva.video_encoder_apply(tparams, tcfg, torch.from_numpy(x)).numpy()
    assert _rel_rms(b, a) < REL_TOL
    with pytest.raises(KeyError):
        tva.import_video_autoencoder_state(
            {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()
             if not k.startswith("decoder.conv_out")}, tcfg, device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_matches_jax_tree_shapes(case):
    """``init_video_autoencoder`` makes the tree the JAX init makes
    (traced, not run), leaf for leaf in the JAX layout."""
    jcfg, tcfg = _cfgs(CASES[case][0])
    ref = jax.eval_shape(lambda k: jva.init_video_autoencoder(k, jcfg), jax.random.PRNGKey(0))
    got = _jax_tree(tva.init_video_autoencoder(tcfg, seed=0, device="cpu"))
    assert {k: tuple(v.shape) for k, v in _leaves(got)} == {
        k: tuple(v.shape) for k, v in _leaves(ref)}
