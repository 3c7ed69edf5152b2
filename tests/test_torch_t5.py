"""The port's T5 encoder (``avatar_tpu_torch/models/t5.py``) against the JAX
package's on the CPU, in f32, at a tiny width: relative-position buckets
exactly, ``t5_encode`` gated-gelu and relu with and without a mask, the HF
state-dict import, loading from a directory the port's safetensors writer
fills, int8 quantization bit for bit and the int8 encodes, and
``encode_prompt`` through a stub tokenizer."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.models import t5 as jt5
from avatar_tpu.utils import quantize as jquant
from avatar_tpu_torch.models import t5 as tt5
from avatar_tpu_torch.utils import quantize as tquant
from avatar_tpu_torch.utils.safetensors_io import save_safetensors
from avatar_tpu_torch.utils.weight_import import t5_params_from_numpy

torch.set_num_threads(2)

CFG = dict(vocab_size=100, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
           relative_attention_num_buckets=8, relative_attention_max_distance=20)
# f32 through two blocks of width 32: the same products summed in another
# order, on hidden states of O(1) after the final norm
ATOL, RTOL = 2e-5, 2e-5


def _cfgs(ff="gated-gelu"):
    return (jt5.T5Config(**CFG, feed_forward_proj=ff),
            tt5.T5Config(**CFG, feed_forward_proj=ff))


def _params(jcfg, seed=1):
    jparams = jt5.init_t5_encoder(jax.random.PRNGKey(seed), jcfg)
    return jparams, jax.tree.map(np.asarray, jparams)


def _ids_mask(masked):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, CFG["vocab_size"], (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.float32)
    if masked:
        mask[1, 8:] = 0.0
    return ids, mask


def _encode_both(jparams, jcfg, tparams, tcfg, masked):
    ids, mask = _ids_mask(masked)
    jmask, tmask = (jnp.asarray(mask), torch.from_numpy(mask)) if masked else (None, None)
    ref = np.asarray(jt5.t5_encode(jparams, jcfg, jnp.asarray(ids), jmask))
    out = tt5.t5_encode(tparams, tcfg, torch.from_numpy(ids), tmask)
    return out.numpy(), ref


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (8, 20)])
def test_relative_position_bucket_exact(num_buckets, max_distance):
    rel = np.arange(-300, 301, dtype=np.int32)
    ref = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), num_buckets,
                                                  max_distance))
    out = tt5.relative_position_bucket(torch.from_numpy(rel), num_buckets, max_distance)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_compute_position_bias_matches_jax():
    table = np.random.default_rng(3).standard_normal((32, 6)).astype(np.float32)
    ref = jt5.compute_position_bias(jnp.asarray(table), 40, 40, 32, 128)
    out = tt5.compute_position_bias(torch.from_numpy(table), 40, 40, 32, 128)
    assert tuple(out.shape) == (1, 6, 40, 40)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("ff", ["gated-gelu", "relu"])
def test_t5_encode_matches_jax(ff, masked):
    jcfg, tcfg = _cfgs(ff)
    jparams, tree = _params(jcfg)
    out, ref = _encode_both(jparams, jcfg, t5_params_from_numpy(tree, device="cpu"),
                            tcfg, masked)
    assert out.shape == (2, 12, CFG["d_model"])
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def _hf_state(tree):
    """The JAX tree in HF ``T5EncoderModel`` names and layouts."""
    state = {"shared.weight": tree["shared"],
             "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
                 tree["rel_bias"],
             "encoder.final_layer_norm.weight": tree["final_norm"]}
    for i, block in enumerate(tree["blocks"]):
        pre = f"encoder.block.{i}.layer"
        for name, lin in block["attn"].items():
            state[f"{pre}.0.SelfAttention.{name}.weight"] = lin["kernel"].T.copy()
        for name, lin in block["ff"].items():
            state[f"{pre}.1.DenseReluDense.{name}.weight"] = lin["kernel"].T.copy()
        state[f"{pre}.0.layer_norm.weight"] = block["attn_norm"]
        state[f"{pre}.1.layer_norm.weight"] = block["ff_norm"]
    return {k: np.array(v) for k, v in state.items()}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, val in tree.items() for k, v in _leaves(val, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, val in enumerate(tree) for k, v in _leaves(val, f"{path}/{i}").items()}
    return {path: tree}


@pytest.mark.parametrize("ff", ["gated-gelu", "relu"])
def test_import_t5_state_matches_jax_tree(ff):
    jcfg, tcfg = _cfgs(ff)
    _, tree = _params(jcfg, seed=2)
    state = _hf_state(tree)
    got = _leaves(tt5.import_t5_state(state, tcfg, device="cpu"))
    want = _leaves(t5_params_from_numpy(tree, device="cpu"))
    assert set(got) == set(want)
    for key, val in want.items():
        assert torch.equal(got[key], val), key
    # and the JAX importer reads the same state into the same tree
    jtree = jax.tree.map(np.asarray, jt5.import_t5_state(state, jcfg))
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(jtree),
                                                     jax.tree.leaves(tree)))


@pytest.mark.parametrize("quantize", [None, "w8a8"])
def test_load_t5_encoder_from_directory(tmp_path, quantize):
    """config.json and two safetensors shards under text_encoder/, written
    by the port's writer: the port's loader and the JAX package's read the
    same encoder."""
    jcfg, _ = _cfgs()
    _, tree = _params(jcfg, seed=3)
    state = _hf_state(tree)
    enc = tmp_path / "text_encoder"
    enc.mkdir()
    keys = sorted(state)
    save_safetensors({k: state[k] for k in keys[: len(keys) // 2]},
                     enc / "model-00001-of-00002.safetensors")
    save_safetensors({k: state[k] for k in keys[len(keys) // 2:]},
                     enc / "model-00002-of-00002.safetensors")
    (enc / "config.json").write_text(json.dumps({**CFG, "feed_forward_proj": "gated-gelu"}))
    tcfg, tparams = tt5.load_t5_encoder(tmp_path, quantize=quantize, device="cpu")
    jcfg2, jparams = jt5.load_t5_encoder(str(tmp_path), quantize=quantize)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg2)
    out, ref = _encode_both(jparams, jcfg2, tparams, tcfg, masked=True)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantize_t5_params_bit_for_bit(mode):
    """The int8 weights and scales equal the JAX package's; norms, the
    embedding and the bias table stay as they were; the int8 encodes
    agree."""
    jcfg, tcfg = _cfgs()
    jparams, tree = _params(jcfg, seed=4)
    jq = jquant.quantize_t5_params(jparams, mode=mode)
    tparams = t5_params_from_numpy(tree, device="cpu")
    tq = tquant.quantize_t5_params(tparams, mode=mode)
    key = "kernel_q8" if mode == "w8a8" else "kernel_q"
    want = _leaves(t5_params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu"))
    got = _leaves(tq)
    assert set(got) == set(want) and any(k.endswith(key) for k in got)
    for name, val in want.items():
        assert got[name].dtype == val.dtype and torch.equal(got[name], val), name
    assert tq["rel_bias"] is tparams["rel_bias"] and tq["shared"] is tparams["shared"]
    out, ref = _encode_both(jq, jcfg, tq, tcfg, masked=True)
    # the same int8 weights; w8a8 also quantizes the activation rows, where
    # an f32 difference of an ulp can move one element across a rounding
    # boundary of max|row| / 127
    tol = ATOL if mode == "w8" else 1e-4
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)
    with pytest.raises(ValueError):
        tquant.quantize_t5_params(tparams, mode="w4")


class _StubTokenizer:
    """Word ids by hashing, padded or truncated to ``max_length``, with the
    HF tokenizer's call signature."""

    def __call__(self, prompts, padding, max_length, truncation, add_special_tokens,
                 return_tensors):
        assert padding == "max_length" and truncation and return_tensors == "np"
        ids = np.zeros((len(prompts), max_length), np.int64)
        mask = np.zeros((len(prompts), max_length), np.int64)
        for i, text in enumerate(prompts):
            words = [sum(map(ord, w)) % 97 + 2 for w in text.split()]
            words = (words + [1] if add_special_tokens else words)[:max_length]
            ids[i, :len(words)] = words
            mask[i, :len(words)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def test_encode_prompt_with_a_stub_tokenizer():
    jcfg, tcfg = _cfgs()
    jparams, tree = _params(jcfg, seed=5)
    prompts = ["a woman talks to the camera", "a man"]
    ref, ref_mask = jt5.encode_prompt(jparams, jcfg, _StubTokenizer(), prompts, 16)
    out, mask = tt5.encode_prompt(t5_params_from_numpy(tree, device="cpu"), tcfg,
                                  _StubTokenizer(), prompts, 16)
    assert out.shape == (2, 16, CFG["d_model"]) and mask.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    single, _ = tt5.encode_prompt(t5_params_from_numpy(tree, device="cpu"), tcfg,
                                  _StubTokenizer(), prompts[1], 16)
    np.testing.assert_allclose(single.numpy()[0], out.numpy()[1], atol=ATOL, rtol=RTOL)


def test_init_t5_encoder_shapes_and_tree():
    """Seeded init: the JAX package's tree, finite encodes, and the same
    parameters from the same seed."""
    jcfg, tcfg = _cfgs()
    params = tt5.init_t5_encoder(tcfg, seed=0, device="cpu")
    want = _leaves(t5_params_from_numpy(_params(jcfg)[1], device="cpu"))
    got = _leaves(params)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    again = _leaves(tt5.init_t5_encoder(tcfg, seed=0, device="cpu"))
    assert all(torch.equal(got[k], again[k]) for k in got)
    ids, mask = _ids_mask(True)
    out = tt5.t5_encode(params, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    assert out.shape == (2, 12, CFG["d_model"]) and bool(torch.isfinite(out).all())
