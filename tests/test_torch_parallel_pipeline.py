"""The port's multi-device generation on a gloo world of 2 CPU processes:
a ``dp_mesh`` pipeline (each rank its rows, the outputs all-gathered),
``sp_mesh`` (Ulysses and ring) and ``pp_mesh`` pipelines give the
one-device pipeline's videos for the same generator (f32; guidance,
avatar media encoded with the generator's noise); and ``AvatarServer``
over the dp pipeline pads a batch of 3 to 4 and drops the padding, each
request's video equal to the one-device server's (bf16, the tolerance of
``tests/test_serving.py::test_dp_mesh_serving``). Each mesh is also held
to the JAX pipeline under the same mesh over 2 of the 8 virtual CPU
devices, on the same weights, the port fed the JAX pipeline's initial
noise (attention "xla" on both sides, ``torch_parity.PIPE_ATOL``)."""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from avatar_tpu.models import dit as jdit
from avatar_tpu.models import vae as jvae
from avatar_tpu.parallel.pipeline import make_pp_mesh as jmake_pp_mesh
from avatar_tpu.pipelines import pipeline as jpipe
from avatar_tpu_torch.pipelines import AvatarServer, GenerationParams, GenerationRequest
from torch_dist import run_world
from torch_parallel_cases import generate, tiny_pipeline
from torch_parity import PIPE_ATOL, PIPE_DIT_KW, dit_numpy_params, vae_numpy_params

WORLD = 2
H = W = 64
PARAMS = dict(height=H, width=W, num_frames=9, frame_rate=25.0, num_inference_steps=2,
              guidance_scale=3.0, stg_scale=0.0, rescaling_scale=1.0, decode_timestep=0.0)


def _case(mesh, seed, output_type="latent", media=False):
    rng = np.random.default_rng(seed)
    case = {"mesh": mesh, "seed": seed, "output_type": output_type, "params": PARAMS,
            "embeds": rng.standard_normal((2, 8, 32)).astype(np.float32),
            "mask": np.ones((2, 8), np.float32),
            "negative_prompt_embeds": rng.standard_normal((2, 8, 32)).astype(np.float32),
            "negative_prompt_attention_mask": np.ones((2, 8), np.float32)}
    if media:
        case["ref_image"] = rng.uniform(-1, 1, (2, 1, H, W, 3)).astype(np.float32)
        case["pose_frames"] = rng.uniform(-1, 1, (2, 9, H, W, 3)).astype(np.float32)
    return case


CASES = {
    "dp_latent": _case("dp", 1, media=True),
    "dp_video": _case("dp", 2, output_type="np"),
    "sp_ulysses": _case("sp_ulysses", 3, media=True),
    "sp_ring": _case("sp_ring", 4),
    "pp": _case("pp", 5, media=True),
}
JAX_MESHES = ("dp", "sp_ulysses", "sp_ring", "pp")
JAX_VAE = dataclasses.replace(jvae.demo_config(latent_channels=8), base_channels=32,
                              decoder_base_channels=32)


def _jax_case(mesh, seed, batch=2):
    """A guided latent generation on conditioning latents, with the initial
    noise the JAX pipeline draws from ``PRNGKey(seed)`` (per sample, from
    the split of its latent key)."""
    rng = np.random.default_rng(seed)
    case = {"mesh": mesh, "jax_weights": True, "jax_key": seed, "seed": 0,
            "output_type": "latent",
            "params": PARAMS,
            "embeds": rng.standard_normal((batch, 8, 32)).astype(np.float32),
            "mask": np.ones((batch, 8), np.float32),
            "negative_prompt_embeds": rng.standard_normal((batch, 8, 32)).astype(np.float32),
            "negative_prompt_attention_mask": np.ones((batch, 8), np.float32),
            "ref_latents": rng.standard_normal((batch, 1, 2, 2, 8)).astype(np.float32),
            "pose_latents": rng.standard_normal((batch, 2, 2, 2, 8)).astype(np.float32)}
    k_lat = jax.random.split(jax.random.PRNGKey(seed), 6)[2]
    case["init_noise"] = np.stack([np.asarray(jax.random.normal(k, (2, 2, 2, 8)))
                                   for k in jax.random.split(k_lat, batch)])
    return case


JAX_CASES = {"jax_" + m: _jax_case(m, 10 + i) for i, m in enumerate(JAX_MESHES)}


def _jax_generation(weights, case):
    """The JAX pipeline's latents for ``case`` under its mesh on 2 devices."""
    devices = np.asarray(jax.devices()[:WORLD])
    mesh = {"dp": lambda: dict(dp_mesh=JMesh(devices, ("data",))),
            "sp_ulysses": lambda: dict(sp_mesh=JMesh(devices, ("sp",))),
            "sp_ring": lambda: dict(sp_mesh=JMesh(devices, ("sp",)), sp_impl="ring"),
            "pp": lambda: dict(pp_mesh=jmake_pp_mesh(pp=WORLD, data=1,
                                                     devices=list(devices)))}[case["mesh"]]()
    dcfg = jdit.DiTConfig(**weights["dit_cfg"])
    pipe = jpipe.LTXVideoPipeline(dcfg, jax.tree.map(jnp.asarray, weights["dit"]), JAX_VAE,
                                  jax.tree.map(jnp.asarray, weights["vae"]),
                                  attention_impl="xla", **mesh)
    kw = {k: jnp.asarray(case[k]) for k in ("negative_prompt_embeds",
                                            "negative_prompt_attention_mask",
                                            "ref_latents", "pose_latents")}
    return np.asarray(pipe(jpipe.GenerationParams(**case["params"]),
                           jax.random.PRNGKey(case["jax_key"]),
                           jnp.asarray(case["embeds"]), jnp.asarray(case["mask"]),
                           output_type="latent", dtype=jnp.float32, **kw))




def _request(seed):
    """A served request with its own avatar media (encoded through the
    server's media cache)."""
    rng = np.random.default_rng(40 + seed)
    return dict(params=dict(PARAMS, guidance_scale=1.0), seed=seed,
                embeds=rng.standard_normal((1, 8, 32)).astype(np.float32),
                mask=np.ones((1, 8), np.float32),
                ref_image=rng.uniform(-1, 1, (1, 1, H, W, 3)).astype(np.float32),
                pose_frames=rng.uniform(-1, 1, (1, 9, H, W, 3)).astype(np.float32))


REQUESTS = [_request(s) for s in (0, 1, 2)]


@pytest.fixture(scope="module")
def results():
    """The world's results and the JAX pipelines' latents by mesh, the JAX
    pipelines run while the world runs."""
    weights = {"dit_cfg": PIPE_DIT_KW, "dit": dit_numpy_params(jdit.DiTConfig(**PIPE_DIT_KW)),
               "vae": vae_numpy_params(JAX_VAE)}
    payload = {"cases": dict(CASES, **JAX_CASES), "requests": REQUESTS, "weights": weights}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(run_world, "generation", WORLD, payload, timeout=150)
        refs = {name: _jax_generation(weights, case) for name, case in JAX_CASES.items()}
        return world.result(), refs


@pytest.fixture(scope="module")
def world(results):
    return results[0]


@pytest.mark.parametrize("name", list(CASES))
def test_generation_matches_one_device(world, name):
    torch.set_num_threads(2)
    ref = generate(tiny_pipeline(), CASES[name]).numpy()
    atol = 1e-4 if CASES[name]["output_type"] == "np" else 2e-5
    for rank, r in enumerate(world):
        np.testing.assert_allclose(r[name].numpy(), ref, atol=atol, err_msg=f"rank {rank}")


@pytest.mark.parametrize("mesh", JAX_MESHES)
def test_generation_matches_jax_under_the_same_mesh(results, mesh):
    """Each rank's latents (the whole batch) against the JAX pipeline's."""
    world, refs = results
    ref = refs["jax_" + mesh]
    assert ref.shape == (2, 2, 2, 2, 8)
    for rank, r in enumerate(world):
        np.testing.assert_allclose(r["jax_" + mesh].numpy(), ref, atol=PIPE_ATOL,
                                   err_msg=f"rank {rank}")


def test_dp_server_pads_and_drops(world):
    pipe = tiny_pipeline()
    server = AvatarServer(pipe, max_batch=1)
    try:
        base = [server.submit(GenerationRequest(
            params=GenerationParams(**r["params"]), prompt_embeds=r["embeds"],
            prompt_attention_mask=r["mask"], ref_image=r["ref_image"],
            pose_frames=r["pose_frames"], seed=r["seed"], output_type="np")).result(
                timeout=300) for r in REQUESTS]
    finally:
        server.shutdown()
    for rank, r in enumerate(world):
        assert r["server_stats"] == {"requests": 3, "batches": 1}
        assert len(r["served"]) == 3
        for got, ref in zip(r["served"], base):
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, ref, atol=2e-3, err_msg=f"rank {rank}")
