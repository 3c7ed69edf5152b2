"""The port's audio models against the JAX package's, on the CPU in f32:
wav2vec2 and FaceFormer (each through the JAX tree's converter and through
the port's own import of one torch state dict) and the vocaset loader
(``tests/test_torch_pose_frames.py`` holds the pose frames and ``--text``).

The models are ``tests/test_faceformer.py``'s tiny ones: a wav2vec2 of
width 32 with two layers and two conv layers (a state dict in Hugging
Face's names, made here without ``transformers``), and its FaceFormer
decoder of width 16, 4 heads and period 5, with 80 vertices; random
weights from seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.models import faceformer as jff
from avatar_tpu.models import wav2vec2 as jw2v
from avatar_tpu_torch.models import faceformer as tff
from avatar_tpu_torch.models import wav2vec2 as tw2v
from avatar_tpu_torch.utils.weight_import import (
    faceformer_params_from_numpy,
    wav2vec2_params_from_numpy,
)
from test_faceformer import _TorchFaceformer

torch.set_num_threads(2)

FDIM, N_VERTS = 16, 80
# f32 on both sides through two post-LN encoder layers (and, for
# FaceFormer, the decoder): the summation orders of XLA's and torch's convs
# and products differ by ~1e-6, the positional conv's weight norm is taken
# in numpy on one side and torch on the other; observed below 3e-6
W2V_ATOL = 2e-5
# the decode feeds each frame's output back as the next frame's input, 7 to
# 12 frames deep, and adds the template
FF_ATOL = 5e-5


# tests/test_faceformer.py's tiny Hugging Face config
W2V_CFG = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, conv_dim=(16, 16), conv_stride=(5, 2),
               conv_kernel=(10, 3), num_conv_pos_embeddings=16,
               num_conv_pos_embedding_groups=4, feat_extract_norm="group")


def _w2v_state(rng):
    """A ``Wav2Vec2Model`` state dict of ``W2V_CFG``'s shapes and names,
    random from ``rng``, the positional conv's weight norm in the newer
    ``parametrizations`` naming."""
    c, h, ff = W2V_CFG["conv_dim"][0], W2V_CFG["hidden_size"], W2V_CFG["intermediate_size"]
    k, g = W2V_CFG["num_conv_pos_embeddings"], W2V_CFG["num_conv_pos_embedding_groups"]

    def u(*shape, fan_in):
        return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32) * fan_in**-0.5)

    s = {"feature_extractor.conv_layers.0.conv.weight": u(c, 1, 10, fan_in=10),
         "feature_extractor.conv_layers.0.layer_norm.weight": 1 + u(c, fan_in=4),
         "feature_extractor.conv_layers.0.layer_norm.bias": u(c, fan_in=4),
         "feature_extractor.conv_layers.1.conv.weight": u(c, c, 3, fan_in=3 * c),
         "feature_projection.layer_norm.weight": 1 + u(c, fan_in=4),
         "feature_projection.layer_norm.bias": u(c, fan_in=4),
         "feature_projection.projection.weight": u(h, c, fan_in=c),
         "feature_projection.projection.bias": u(h, fan_in=c),
         "encoder.pos_conv_embed.conv.parametrizations.weight.original0": 1 + u(
             1, 1, k, fan_in=4),
         "encoder.pos_conv_embed.conv.parametrizations.weight.original1": u(
             h, h // g, k, fan_in=h // g * k),
         "encoder.pos_conv_embed.conv.bias": u(h, fan_in=h),
         "encoder.layer_norm.weight": 1 + u(h, fan_in=4),
         "encoder.layer_norm.bias": u(h, fan_in=4)}
    for i in range(W2V_CFG["num_hidden_layers"]):
        pre = f"encoder.layers.{i}"
        for name in ("q", "k", "v", "out"):
            s[f"{pre}.attention.{name}_proj.weight"] = u(h, h, fan_in=h)
            s[f"{pre}.attention.{name}_proj.bias"] = u(h, fan_in=h)
        for name, (o, n) in (("intermediate_dense", (ff, h)), ("output_dense", (h, ff))):
            s[f"{pre}.feed_forward.{name}.weight"] = u(o, n, fan_in=n)
            s[f"{pre}.feed_forward.{name}.bias"] = u(o, fan_in=n)
        for name in ("layer_norm", "final_layer_norm"):
            s[f"{pre}.{name}.weight"] = 1 + u(h, fan_in=4)
            s[f"{pre}.{name}.bias"] = u(h, fan_in=4)
    return s


@pytest.fixture(scope="module")
def models():
    """(the wav2vec2 and FaceFormer configs of both packages, the
    vocaset-layout state dict as torch tensors and as numpy arrays)."""
    state = {f"audio_encoder.{k}": v for k, v in _w2v_state(np.random.default_rng(7)).items()}
    torch.manual_seed(2)
    dec = _TorchFaceformer(feature_dim=FDIM, vertice_dim=N_VERTS * 3, period=5)
    audio_feature_map = torch.nn.Linear(W2V_CFG["hidden_size"], FDIM)
    state["audio_feature_map.weight"] = audio_feature_map.weight.detach()
    state["audio_feature_map.bias"] = audio_feature_map.bias.detach()
    state.update({k: v for k, v in dec.state_dict().items()
                  if k.startswith(("vertice_map", "obj_vector", "transformer_decoder"))})
    state = {k: v.detach().clone() for k, v in state.items()}
    cfgs = (jw2v.Wav2Vec2Config.from_dict(W2V_CFG), tw2v.Wav2Vec2Config.from_dict(W2V_CFG),
            jff.FaceFormerConfig(feature_dim=FDIM, vertice_dim=N_VERTS * 3, period=5),
            tff.FaceFormerConfig(feature_dim=FDIM, vertice_dim=N_VERTS * 3, period=5))
    return cfgs, state, {k: v.numpy() for k, v in state.items()}


def _audio(n=3200, seed=0):
    return (np.random.default_rng(seed).standard_normal((1, n)) * 0.1).astype(np.float32)


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def test_linear_interpolation_matches_jax():
    """Positions and weights as XLA forms them: the same frames to 1e-6."""
    rng = np.random.default_rng(1)
    for t, n in ((37, 22), (37, 61), (37, 37), (37, 1), (319, 12), (799, 479), (242, 145)):
        x = rng.standard_normal((2, t, 8)).astype(np.float32)
        np.testing.assert_allclose(
            tw2v.linear_interpolation(torch.from_numpy(x), 50, 30, output_len=n).numpy(),
            np.asarray(jw2v.linear_interpolation(jnp.asarray(x), 50, 30, output_len=n)),
            atol=1e-6)


def test_bias_rows_and_encoding_match_jax():
    np.testing.assert_array_equal(tff.alibi_slopes(6), jff.alibi_slopes(6))
    slopes = tff.alibi_slopes(4)
    for i in (0, 1, 7, 36):
        np.testing.assert_array_equal(
            tff.biased_causal_row(torch.from_numpy(slopes).float(), i, 37, 5).numpy(),
            np.asarray(jff.biased_causal_row(jnp.asarray(slopes, jnp.float32),
                                             jnp.asarray(i), 37, 5)))
    np.testing.assert_array_equal(tff.periodic_positional_encoding(16, 5, 40),
                                  jff.periodic_positional_encoding(16, 5, 40))


@pytest.mark.parametrize("frame_num", [12, None])
def test_wav2vec2_matches_jax_both_routes(models, frame_num):
    """The JAX encoder against the port on the converted JAX tree and on
    its own import of the same state dict."""
    (jcfg, tcfg, _, _), state, np_state = models
    w2v_np = {k[len("audio_encoder."):]: v for k, v in np_state.items()
              if k.startswith("audio_encoder.")}
    jparams = jw2v.import_wav2vec2_state(w2v_np, jcfg)
    ref = np.asarray(jw2v.wav2vec2_encode(jparams, jcfg, jnp.asarray(_audio()),
                                          output_len=frame_num))
    routes = {
        "converter": wav2vec2_params_from_numpy(_np_tree(jparams), device="cpu"),
        "import": tw2v.import_wav2vec2_state(
            {k[len("audio_encoder."):]: v for k, v in state.items()
             if k.startswith("audio_encoder.")}, tcfg, device="cpu"),
    }
    for name, params in routes.items():
        out = tw2v.wav2vec2_encode(params, tcfg, torch.from_numpy(_audio()),
                                   output_len=frame_num)
        np.testing.assert_allclose(out.numpy(), ref, atol=W2V_ATOL, err_msg=name)


def test_faceformer_matches_jax_both_routes(models):
    """faceformer_predict and extract_audio_motion_features, on the
    converted JAX tree and on the port's import of the state dict."""
    (jw, tw, jcfg, tcfg), state, np_state = models
    jparams = jff.import_faceformer_state(np_state, jw)
    audio = _audio(4000, seed=3)
    template = np.random.default_rng(4).standard_normal((1, N_VERTS * 3)).astype(np.float32)
    one_hot = np.zeros((1, 8), np.float32)
    one_hot[0, 2] = 1.0
    ref_v = np.asarray(jff.faceformer_predict(jparams, jcfg, jw, jnp.asarray(audio),
                                              jnp.asarray(template), jnp.asarray(one_hot)))
    ref_f = np.asarray(jff.extract_audio_motion_features(jparams, jcfg, jw,
                                                         jnp.asarray(audio), frame_num=9))
    for name, params in (("converter", faceformer_params_from_numpy(_np_tree(jparams),
                                                                    device="cpu")),
                         ("import", tff.import_faceformer_state(state, tw, device="cpu"))):
        v = tff.faceformer_predict(params, tcfg, tw, torch.from_numpy(audio),
                                   torch.from_numpy(template), torch.from_numpy(one_hot))
        f = tff.extract_audio_motion_features(params, tcfg, tw, torch.from_numpy(audio),
                                              frame_num=9)
        assert v.shape == ref_v.shape and f.shape == ref_f.shape == (1, 9, FDIM)
        np.testing.assert_allclose(v.numpy(), ref_v, atol=FF_ATOL, err_msg=name)
        np.testing.assert_allclose(f.numpy(), ref_f, atol=FF_ATOL, err_msg=name)
    embeds = tff.audio_features_to_caption_embeds(f, 24)
    np.testing.assert_array_equal(
        embeds.numpy(), np.asarray(jff.audio_features_to_caption_embeds(jnp.asarray(
            f.numpy()), 24)))


def test_load_faceformer_reads_the_vocaset_state(models, tmp_path):
    """``load_faceformer`` reads a torch-saved vocaset-layout state dict
    (and a pickled module's ``state_dict()``) into the tree the import
    makes."""
    (_, tw, _, _), state, _ = models
    torch.save(state, tmp_path / "vocaset.pth")
    ff_cfg, w2v_cfg, params = tff.load_faceformer(str(tmp_path / "vocaset.pth"), tw,
                                                  device="cpu")
    assert ff_cfg == tff.FaceFormerConfig() and w2v_cfg is tw
    ref = tff.import_faceformer_state(state, tw, device="cpu")
    from avatar_tpu_torch.train.train import tree_map

    tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b.numpy()), params, ref)
