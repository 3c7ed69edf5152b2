"""The port's pipeline parallelism on a gloo world of 4 CPU processes (4
stages, and 2 stages x 2 data ranks), held to the JAX package's unsharded
``dit_apply`` on the same weights, in f32: microbatches, the per-token
timestep, the STG skip mask, the hoisted cross-attention k/v, stacked
LoRA, the data axis (and its replicated fallback), and the gradients
through the schedule (also under remat "full" and "dots"). One world runs
every case; tolerances are the JAX tests' own (2e-5 forward; ``atol=5e-5,
rtol=1e-4`` for gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from avatar_tpu.models import dit as jdit
from avatar_tpu.ops import rope as jrope
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.utils.weight_import import dit_params_from_numpy
from torch_dist import run_world
from torch_parity import dit_numpy_params

WORLD = 4
CFG_KW = dict(num_attention_heads=2, attention_head_dim=16, in_channels=8, out_channels=8,
              num_layers=4, cross_attention_dim=32, caption_channels=24)
B, F_, H_, W_, LK, RANK = 4, 2, 4, 4, 8, 4

CASES = {
    "pp4": dict(mesh="pp4", microbatches=2, impl="xla"),
    "pp4_token_t_flash": dict(mesh="pp4", microbatches=4, impl="flash", token_t=True),
    "pp2_data2": dict(mesh="pp2_data2", microbatches=2, impl="xla"),
    "pp2_data2_replicated": dict(mesh="pp2_data2", microbatches=4, impl="xla"),
    "pp4_skip_mask": dict(mesh="pp4", microbatches=2, impl="xla",
                          strategy="TransformerBlock"),
    "pp2_data2_stg_values": dict(mesh="pp2_data2", impl="xla", strategy="AttentionValues"),
    "pp2_data2_hoisted_lora": dict(mesh="pp2_data2", microbatches=2, impl="xla",
                                   hoisted=True, lora=True),
    "pp4_grad": dict(mesh="pp4", microbatches=2, impl="xla", grad=True),
    "pp2_data2_lora_grad": dict(mesh="pp2_data2", microbatches=2, impl="xla", grad=True,
                                lora=True),
    "pp4_remat_full_grad": dict(mesh="pp4", microbatches=2, impl="xla", grad=True,
                                remat="full"),
    "pp2_data2_remat_dots_grad": dict(mesh="pp2_data2", microbatches=2, impl="xla",
                                      grad=True, remat="dots", lora=True),
}


def _lora_numpy(rng):
    inner = CFG_KW["num_attention_heads"] * CFG_KW["attention_head_dim"]
    dims = {"to_q": inner, "to_k": CFG_KW["cross_attention_dim"],
            "to_v": CFG_KW["cross_attention_dim"], "to_out": inner}
    return {"blocks": [{"attn2": {n: {
        "a": (0.3 * rng.standard_normal((d, RANK))).astype(np.float32),
        "b": (0.3 * rng.standard_normal((RANK, inner))).astype(np.float32)}
        for n, d in dims.items()}} for _ in range(CFG_KW["num_layers"])]}


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(21)
    n = F_ * H_ * W_
    mask = (rng.uniform(size=(B, LK)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    inputs = {
        "tokens": rng.standard_normal((B, n, 8)).astype(np.float32),
        "grid": np.asarray(jrope.get_latent_coords(F_, H_, W_, batch_size=B), np.float32),
        "text": rng.standard_normal((B, LK, 24)).astype(np.float32),
        "mask": mask,
        "target": rng.standard_normal((B, n, 8)).astype(np.float32),
    }
    cases = {}
    for name, case in CASES.items():
        case = dict(case)
        shape = (B, n) if case.get("token_t") else (B,)
        case["t"] = rng.uniform(0.1, 1.0, size=shape).astype(np.float32)
        if case.get("strategy"):
            slm = np.ones((CFG_KW["num_layers"], B), np.float32)
            slm[1, 1::2] = 0.0
            slm[3, 0] = 0.0
            case["skip_layer_mask"] = slm
        if case.get("lora"):
            case["lora"] = _lora_numpy(rng)
        cases[name] = case
    jcfg = jdit.DiTConfig(**CFG_KW)
    tree = dit_numpy_params(jcfg)
    payload = {"dit_cfg": CFG_KW, "inputs": inputs, "cases": cases,
               "dit_params": dit_params_from_numpy(tree, tdit.DiTConfig(**CFG_KW),
                                                   device="cpu")}
    return payload, tree, run_world("pipeline", WORLD, payload, timeout=150)


def _jax_apply(params, case, x):
    jcfg = jdit.DiTConfig(**CFG_KW)
    kw = dict(attention_impl=case["impl"])
    if case.get("skip_layer_mask") is not None:
        kw.update(skip_layer_mask=jnp.asarray(case["skip_layer_mask"]),
                  skip_layer_strategy=jdit.SkipLayerStrategy[case["strategy"]])
    if case.get("lora") is not None:
        kw.update(lora=jax.tree.map(jnp.asarray, case["lora"]), lora_scale=0.5)
    return jdit.dit_apply(params, jcfg, x["tokens"], x["grid"], case["t"], x["text"],
                          x["mask"], **kw)


FORWARD = [n for n, c in CASES.items() if not c.get("grad")]
GRADIENT = [n for n, c in CASES.items() if c.get("grad")]


@pytest.mark.parametrize("name", FORWARD)
def test_dit_apply_pp_matches_unsharded_jax(world, name):
    payload, tree, results = world
    case, x = payload["cases"][name], payload["inputs"]
    ref = np.asarray(_jax_apply(jax.tree.map(jnp.asarray, tree), case, x))
    for rank, r in enumerate(results):
        np.testing.assert_allclose(r[name].numpy(), ref, atol=2e-5, err_msg=f"rank {rank}")


@pytest.mark.parametrize("name", GRADIENT)
def test_dit_apply_pp_gradients_match_unsharded_jax(world, name):
    """Every rank differentiates the loss it holds over the world size and
    the gradients are summed over the ranks holding the same leaf: the
    outer params' over all, each stage's blocks' over the data axis."""
    payload, tree, results = world
    case, x = payload["cases"][name], payload["inputs"]

    def loss(p):
        out = _jax_apply(p, case, x)
        return jnp.mean((out - x["target"]) ** 2)

    params = jax.tree.map(jnp.asarray, tree)
    ref_loss, ref = jax.value_and_grad(loss)(params)
    ref = jax.tree.map(np.asarray, ref)
    per = CFG_KW["num_layers"] // (4 if case["mesh"] == "pp4" else 2)
    got_blocks = {}
    for r in results:
        grads = r[name]["grads"]
        np.testing.assert_allclose(float(r[name]["loss"]), float(ref_loss), rtol=1e-5)
        for i, blk in enumerate(grads["blocks"]):
            got_blocks[grads["stage"] * per + i] = blk
    port = dict(results[0][name]["grads"],
                blocks=[got_blocks[i] for i in range(len(got_blocks))])
    port.pop("stage")
    ref_port = dit_params_from_numpy(ref, tdit.DiTConfig(**CFG_KW), device="cpu")

    def close(a, b, path=""):
        if isinstance(b, dict):
            for k in b:
                close(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, list):
            for i, (ai, bi) in enumerate(zip(a, b)):
                close(ai, bi, f"{path}/{i}")
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5, rtol=1e-4,
                                       err_msg=path)

    close(port, ref_port)
