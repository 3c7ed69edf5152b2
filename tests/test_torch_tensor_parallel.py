"""The port's tensor-parallel DiT forward on a gloo world of 2 CPU
processes (each rank two of the four heads and half the FFN columns, an
all-reduce after to_out and proj_out and for the q/k norms' sums), held to
the JAX package's unsharded ``dit_apply`` on the same weights, in f32:
split-RoPE and interleaved layouts, the token-major kernels' plain
versions ("flash") and the XLA path, the per-token timestep, STG. The JAX
package gets its tensor parallelism from placement alone
(``dit_param_sharding``); the port's slices are those placements' blocks
of the unpermuted tree (``tests/test_torch_parallel_mesh.py``)."""

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

WORLD = 2
CFG_KW = dict(num_attention_heads=4, attention_head_dim=16, in_channels=16, out_channels=16,
              num_layers=2, cross_attention_dim=64, caption_channels=96)
B, F_, H_, W_, LK = 2, 2, 4, 8, 16
CASES = {
    "split_flash": dict(split=True, impl="flash"),
    "split_xla": dict(split=True, impl="xla"),
    "interleaved_flash_token_t": dict(split=False, impl="flash", token_t=True),
    "split_stg": dict(split=True, impl="flash", strategy="AttentionValues"),
}


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(31)
    mask = np.ones((B, LK), np.float32)
    mask[0, 10:] = 0.0
    inputs = {"tokens": rng.standard_normal((B, F_ * H_ * W_, 16)).astype(np.float32),
              "grid": np.asarray(jrope.get_latent_coords(F_, H_, W_, batch_size=B),
                                 np.float32),
              "text": rng.standard_normal((B, LK, 96)).astype(np.float32), "mask": mask}
    cases = {}
    for name, case in CASES.items():
        case = dict(case)
        shape = (B, F_ * H_ * W_) if case.get("token_t") else (B,)
        case["t"] = rng.uniform(0.1, 0.9, size=shape).astype(np.float32)
        if case.get("strategy"):
            slm = np.ones((2, B), np.float32)
            slm[1, 1] = 0.0
            case["skip_layer_mask"] = slm
        cases[name] = case
    tree = dit_numpy_params(jdit.DiTConfig(**CFG_KW))
    payload = {"dit_cfg": CFG_KW, "inputs": inputs, "cases": cases,
               "dit_params": dit_params_from_numpy(tree, tdit.DiTConfig(**CFG_KW),
                                                   device="cpu")}
    return payload, tree, run_world("tensor", WORLD, payload, timeout=120)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_forward_matches_unsharded_jax(world, name):
    payload, tree, results = world
    case, x = payload["cases"][name], payload["inputs"]
    jcfg = jdit.DiTConfig(**CFG_KW)
    jp = jax.tree.map(jnp.asarray, tree)
    if case["split"]:
        jp = jdit.permute_dit_params_for_split_rope(jp, jcfg)
    kw = {}
    if case.get("strategy"):
        kw = dict(skip_layer_mask=jnp.asarray(case["skip_layer_mask"]),
                  skip_layer_strategy=jdit.SkipLayerStrategy[case["strategy"]])
    ref = np.asarray(jdit.dit_apply(jp, jcfg, x["tokens"], x["grid"], case["t"], x["text"],
                                    x["mask"], attention_impl=case["impl"],
                                    rope_split=case["split"], **kw))
    for rank, r in enumerate(results):
        assert r[name + "_heads"] == 32  # 2 of the 4 heads of 16 on each rank
        np.testing.assert_allclose(r[name].numpy(), ref, atol=2e-5, err_msg=f"rank {rank}")
