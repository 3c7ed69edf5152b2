"""The port's sharded train step on a gloo world of 2 CPU processes, held
to the JAX package's step sharded the same way over 2 of the 8 virtual CPU
devices: "dp", "zero2" and "fsdp" by placement (``param_sharding``,
``opt_state_sharding``, the batch over ('data', 'fsdp')), "sp" through
``sp_mesh`` (Ulysses), "pp" through ``pp_mesh`` (blocks and
LoRA blocks stacked and stage-sharded). jax.random's draws cannot be made
in torch, so the port is fed per step the t and noise that the JAX step
draws from its key (``torch_parallel_train_setup.train_payload``). f32 on
both sides, the port's plain attention against XLA's: the tolerances of
``test_torch_train.py``'s step against the JAX step."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from avatar_tpu.core.config import TrainConfig as JConfig
from avatar_tpu.models import dit as jdit
from avatar_tpu.parallel import mesh as jmesh
from avatar_tpu.parallel import pipeline as jpipe
from avatar_tpu.train import train as jtrain
from avatar_tpu_torch.train import train as ttrain
from avatar_tpu_torch.utils.weight_import import _convert, lora_from_numpy
from torch_dist import run_world
from torch_parallel_train_setup import DIT_KW, JAX_CASES, STEPS, WORLD, train_payload
from torch_parity import dit_numpy_params

TREE_ATOL, LOSS_RTOL = 2e-5, 1e-5


@pytest.fixture(scope="module")
def setup():
    return train_payload(jax_fed=True)


@pytest.fixture(scope="module")
def results(setup):
    """The world's results and the JAX steps' (metrics, trainable) by case,
    the JAX steps compiled and run while the world runs."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(run_world, "train", WORLD, setup, timeout=150)
        refs = {name: _jax_sharded_steps(setup, "jax_" + name) for name in JAX_CASES}
        return world.result(), refs


def _jax_sharded_steps(setup, name):
    """The JAX step over 2 devices, sharded as ``name``'s mode: metrics per
    step and the trainable after them (pp's LoRA blocks unstacked)."""
    case = setup["cases"][name]
    mode, cfg = case["mode"], JConfig(**case["cfg"])
    devices = np.asarray(jax.devices()[:WORLD])
    jdcfg = jdit.DiTConfig(**DIT_KW)
    params = jdit.permute_dit_params_for_split_rope(
        jax.tree.map(jnp.asarray, dit_numpy_params(jdcfg)), jdcfg)
    # copies: the step donates its trainable and optimizer state
    trainable = jax.tree.map(lambda x: jnp.array(x, copy=True), {
        "lora": setup["jax_lora"], "caption_projection": params["caption_projection"]})
    batch = jax.tree.map(jnp.asarray, setup["batch"])
    opt = jtrain.make_optimizer(cfg)
    kw = {}
    if mode in ("dp", "zero2", "fsdp"):
        mesh = jmesh.make_mesh(data=WORLD if mode == "dp" else 1,
                               fsdp=1 if mode == "dp" else WORLD, devices=list(devices))
        params = jmesh.shard_pytree(params, jmesh.param_sharding(mesh, params, mode, 64))
        t_shard = jmesh.param_sharding(mesh, trainable, mode, 64)
        trainable = jmesh.shard_pytree(trainable, t_shard)
        state = opt.init(trainable)
        o_shard = jmesh.opt_state_sharding(mesh, state, t_shard, mode, 64)
        state = jmesh.shard_pytree(state, o_shard)
        kw = dict(trainable_sharding=t_shard, opt_state_sharding=o_shard)
        rows = NamedSharding(mesh, P(None, ("data", "fsdp")))
        batch = {k: jax.device_put(v, rows) for k, v in batch.items()}
    elif mode == "sp":
        kw = dict(sp_mesh=JMesh(devices.reshape(1, WORLD), ("data", "sp")))
        state = opt.init(trainable)
    else:
        mesh = jpipe.make_pp_mesh(pp=WORLD, data=1, devices=list(devices))
        params = dict(params, blocks=jpipe.stack_block_params(params["blocks"]))
        params = jax.tree.map(jax.device_put, params, jpipe.pp_param_sharding(mesh, params))
        lora = dict(trainable["lora"],
                    blocks=jpipe.stack_block_params(trainable["lora"]["blocks"]))
        trainable = dict(trainable, lora=jax.tree.map(
            jax.device_put, lora, jpipe.pp_param_sharding(mesh, lora)))
        state = opt.init(trainable)
        kw = dict(pp_mesh=mesh)
    step = jtrain.make_train_step(jdcfg, cfg, opt, attention_impl=case["impl"],
                                  rope_split=True, **kw)
    metrics = []
    for s in range(STEPS):
        trainable, state, m = step(trainable, state, params, batch,
                                   jnp.asarray(setup["embeds"]), jnp.asarray(setup["mask"]),
                                   jax.random.PRNGKey(10 + s))
        metrics.append({k: float(v) for k, v in m.items()})
    if mode == "pp":
        trainable = dict(trainable, lora=dict(
            trainable["lora"],
            blocks=jpipe.unstack_block_params(trainable["lora"]["blocks"])))
    trainable = jax.tree.map(np.asarray, trainable)
    return metrics, {"lora": lora_from_numpy(trainable["lora"], device="cpu"),
                     "caption_projection": _convert(trainable["caption_projection"],
                                                    "cpu", torch.float32)}


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_step_matches_jax_sharded_step(results, name):
    """Loss metrics each step and the trainable after two steps: the port's
    gloo world against the JAX step under the same mode's sharding."""
    world, refs = results
    ref_metrics, ref_trainable = refs[name]
    for rank, r in enumerate(world):
        got = r["jax_" + name]
        for step, (m, ref) in enumerate(zip(got["metrics"], ref_metrics, strict=True)):
            for k in ("loss", "rel_mse", "nrmse"):
                np.testing.assert_allclose(m[k], ref[k], rtol=LOSS_RTOL,
                                           err_msg=f"rank {rank} step {step} {k}")
        ttrain.tree_map(lambda a, b: np.testing.assert_allclose(
            a.detach().numpy(), b.detach().numpy(), atol=TREE_ATOL,
            err_msg=f"rank {rank}"), got["trainable"], ref_trainable)
