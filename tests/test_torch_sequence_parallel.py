"""The port's sequence parallelism on a gloo world of 4 CPU processes,
held to the JAX package's on its virtual-device mesh, in f32.

- Ulysses (kv-masked) and the dense ring (online and bounded, masked, a
  fully-masked row uniform) against JAX's ``ulysses_attention`` /
  ``ring_attention`` under ``shard_map``; the flash ring (the flash
  kernels' plain versions per chunk) against JAX's ``ring_flash_attention``
  with Pallas in interpret mode, forward and gradients, a fully-masked row
  giving 0 and no gradient.
- ``dit_apply_sp`` (Ulysses and ring, a ('data', 'sp') mesh, STG) against
  the JAX package's unsharded ``dit_apply`` on the same weights.

One world runs every case (a module fixture); tolerances are the JAX
tests' own (2e-5 forward, 3e-5 gradients).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from avatar_tpu.models import dit as jdit
from avatar_tpu.ops import rope as jrope
from avatar_tpu.parallel import sequence as jseq
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.utils.weight_import import dit_params_from_numpy
from torch_dist import run_world
from torch_parity import dit_numpy_params

WORLD = 4
FWD_ATOL, GRAD_ATOL = 2e-5, 3e-5
B, H, N, D = 1, 4, 128, 16
CFG_KW = dict(num_attention_heads=4, attention_head_dim=16, in_channels=16, out_channels=16,
              num_layers=2, cross_attention_dim=64, caption_channels=96)
F_, H_, W_, LK = 2, 4, 8, 16


def _attention_inputs(seed, mask=None):
    rng = np.random.default_rng(seed)
    case = {n: rng.standard_normal((B, H, N, D)).astype(np.float32)
            for n in ("q", "k", "v", "cot")}
    if mask == "partial":
        case["mask"] = (rng.uniform(size=(B, N)) > 0.3).astype(np.float32)
    elif mask == "none_kept":
        case["mask"] = np.zeros((B, N), np.float32)
    elif mask == "shard_and_rows":
        # the whole second rank's shard masked, and a scatter elsewhere
        m = (rng.uniform(size=(B, N)) > 0.2).astype(np.float32)
        m[:, N // WORLD:2 * N // WORLD] = 0.0
        case["mask"] = m
    return case


ATTENTION = {
    "ulysses_masked": ("ulysses", "partial", {"attention_impl": "auto"}),
    "ring_online": ("ring", None, {"chunk_impl": "dense"}),
    "ring_bounded": ("ring", None, {"chunk_impl": "dense", "bounded_logits": True}),
    "ring_online_masked": ("ring", "partial", {"chunk_impl": "dense"}),
    "ring_bounded_masked": ("ring", "partial", {"chunk_impl": "dense",
                                                "bounded_logits": True}),
    "ring_online_uniform": ("ring", "none_kept", {"chunk_impl": "dense"}),
    "ring_bounded_uniform": ("ring", "none_kept", {"chunk_impl": "dense",
                                                  "bounded_logits": True}),
    "flash_online": ("flash", None, {}),
    "flash_bounded": ("flash", None, {"bounded_logits": True}),
    "flash_masked": ("flash", "shard_and_rows", {"bounded_logits": True}),
    "flash_none_kept": ("flash", "none_kept", {}),
}

DIT = {
    "ulysses": dict(mesh="sp", sp_impl="ulysses", impl="flash"),
    "ring": dict(mesh="sp", sp_impl="ring", impl="flash"),
    "ring_xla": dict(mesh="sp", sp_impl="ring", impl="xla"),
    "ulysses_data": dict(mesh="data_sp", sp_impl="ulysses", impl="flash",
                         data_axis="data"),
    "ring_data_stg": dict(mesh="data_sp", sp_impl="ring", impl="flash", data_axis="data",
                          strategy="AttentionValues"),
}


def _dit_inputs():
    rng = np.random.default_rng(11)
    mask = np.ones((2, LK), np.float32)
    mask[0, 10:] = 0.0
    return {
        "tokens": rng.standard_normal((2, F_ * H_ * W_, 16)).astype(np.float32),
        "grid": np.asarray(jrope.get_latent_coords(F_, H_, W_, batch_size=2), np.float32),
        "text": rng.standard_normal((2, LK, 96)).astype(np.float32),
        "mask": mask,
    }


@pytest.fixture(scope="module")
def world():
    attention = {}
    for i, (name, (kind, mask, kw)) in enumerate(ATTENTION.items()):
        attention[name] = dict(_attention_inputs(i, mask), kind=kind, kw=kw)
    jcfg = jdit.DiTConfig(**CFG_KW)
    tree = dit_numpy_params(jcfg)
    tcfg = tdit.DiTConfig(**CFG_KW)
    rng = np.random.default_rng(5)
    dit = {}
    for name, case in DIT.items():
        case = dict(case, t=rng.uniform(0.1, 0.9, size=(2,)).astype(np.float32))
        if case.get("strategy"):
            slm = np.ones((2, 2), np.float32)
            slm[1, 1] = 0.0
            case["skip_layer_mask"] = slm
        dit[name] = case
    payload = {"attention": attention, "dit": dit, "dit_cfg": CFG_KW,
               "dit_params": dit_params_from_numpy(tree, tcfg, device="cpu"),
               "dit_inputs": _dit_inputs()}
    results = run_world("sequence", WORLD, payload, timeout=150)
    return payload, tree, results


def _gathered(results, section, name, key, dim):
    return torch.cat([r[section][name][key] for r in results], dim=dim).numpy()


def _jax_mesh():
    return Mesh(np.asarray(jax.devices()[:WORLD]), ("sp",))


def _jax_attention(case):
    kind, kw = case["kind"], dict(case["kw"])
    q, k, v, cot = (jnp.asarray(case[n]) for n in ("q", "k", "v", "cot"))
    mask = None if case.get("mask") is None else jnp.asarray(case["mask"])
    tok = P(None, None, "sp", None)
    if kind == "ulysses":
        fn = partial(jseq.ulysses_attention, axis_name="sp", attention_impl="xla")
    elif kind == "ring":
        fn = partial(jseq.ring_attention, axis_name="sp", **kw)
    else:
        fn = partial(jseq.ring_flash_attention, axis_name="sp", **kw)
    specs = (tok,) * 3 + ((P(None, "sp"),) if mask is not None else ())

    def body(*args):
        if mask is None:
            return fn(*args)
        return fn(*args[:3], kv_mask=args[3])

    mapped = jax.jit(shard_map(body, mesh=_jax_mesh(), in_specs=specs, out_specs=tok,
                               check_vma=False))
    extra = (mask,) if mask is not None else ()

    def loss(q, k, v):
        return jnp.sum(mapped(q, k, v, *extra) * cot)

    out = mapped(q, k, v, *extra)
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", list(ATTENTION))
def test_sequence_attention_matches_jax(world, name):
    payload, _, results = world
    case = payload["attention"][name]
    ref_out, ref_grads = _jax_attention(case)
    out = _gathered(results, "attention", name, "out", 2)
    np.testing.assert_allclose(out, ref_out, atol=FWD_ATOL)
    for key, ref in zip(("dq", "dk", "dv"), ref_grads):
        np.testing.assert_allclose(_gathered(results, "attention", name, key, 2), ref,
                                   atol=GRAD_ATOL, err_msg=key)
    if case["kind"] == "flash" and case.get("mask") is not None and not case["mask"].any():
        assert not out.any()  # the kernels' convention: 0, not uniform
    if case["kind"] == "ring" and case.get("mask") is not None and not case["mask"].any():
        uniform = case["v"].mean(axis=2, keepdims=True)
        np.testing.assert_allclose(out, np.broadcast_to(uniform, out.shape), atol=FWD_ATOL)


@pytest.mark.parametrize("name", list(DIT))
def test_dit_apply_sp_matches_unsharded_jax(world, name):
    payload, tree, results = world
    case, x = payload["dit"][name], payload["dit_inputs"]
    jcfg = jdit.DiTConfig(**CFG_KW)
    jp = jdit.permute_dit_params_for_split_rope(jax.tree.map(jnp.asarray, tree), jcfg)
    slm = case.get("skip_layer_mask")
    ref = jdit.dit_apply(
        jp, jcfg, x["tokens"], x["grid"], case["t"], x["text"], x["mask"],
        attention_impl=case["impl"], rope_split=True,
        skip_layer_mask=None if slm is None else jnp.asarray(slm),
        skip_layer_strategy=(None if case.get("strategy") is None
                             else jdit.SkipLayerStrategy[case["strategy"]]))
    for rank, r in enumerate(results):
        np.testing.assert_allclose(r["dit"][name].numpy(), np.asarray(ref), atol=FWD_ATOL,
                                   err_msg=f"rank {rank}")
