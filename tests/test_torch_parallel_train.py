"""The port's sharded train step on a gloo world of 2 CPU processes,
held to the port's one-device step on the whole batch (f32, two optimizer
steps, accumulation 2, the same generator for the draws): every sharding
mode ("dp", "zero2" and "fsdp" with most leaves sharded, "sp" with Ulysses
and the ring, "pp") with AdamW and Adafactor, "lora_audio" and "full",
clipping over shards; FSDP freeing what it gathers; Adafactor's factored
moments on leaves split along either axis; and the training CLI as two
processes joined by ``--coordinator``, whose losses equal a one-process
run's. ``test_torch_parallel_train_jax.py`` holds each mode to the JAX
package's step sharded alike.

The draws of a sharded step are the whole batch's (every rank draws, each
takes its rows) and the loss every rank differentiates is divided by the
ranks that share it (the sp / pp ranks hold the whole output): the
"dp"/"zero2"/"fsdp" cases cover the first, "sp" and "pp" the second.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from avatar_tpu_torch.core.config import TrainConfig
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.train import train as ttrain
from torch_dist import REPO, _free_port, run_world
from torch_parallel_cases import capture_gradients
from torch_parallel_train_setup import (
    ACCUM,
    CASES,
    DIT_KW,
    F_,
    HW,
    SEED,
    STEPS,
    WORLD,
    train_payload,
)

# f32, the same attention path on both sides: the sharded step only sums
# in another order (1e-7 relative observed on the gradients)
TREE_ATOL, LOSS_RTOL, GRAD_RTOL = 2e-5, 1e-5, 1e-4


@pytest.fixture(scope="module")
def setup():
    return train_payload()


@pytest.fixture(scope="module")
def world(setup):
    return run_world("train", WORLD, setup, timeout=150)


def _one_device(setup, case):
    dcfg = tdit.DiTConfig(**DIT_KW)
    cfg = TrainConfig(**case["cfg"])
    opt = ttrain.make_optimizer(cfg)
    grads = capture_gradients(opt)
    trainable = setup["trainable"][case["train"]]
    state = opt.init(trainable)
    step = ttrain.make_train_step(dcfg, cfg, opt, attention_impl=case["impl"],
                                  rope_split=case["rope_split"])
    params = setup["params_split"] if case["rope_split"] else setup["params"]
    batch = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    gen = torch.Generator().manual_seed(SEED)
    metrics = []
    for _ in range(STEPS):
        trainable, state, m = step(trainable, state, params, batch,
                                   torch.from_numpy(setup["embeds"]),
                                   torch.from_numpy(setup["mask"]), gen)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, trainable, grads


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_one_device(setup, world, name):
    ref_metrics, ref_trainable, ref_grads = _one_device(setup, setup["cases"][name])
    for rank, r in enumerate(world):
        got = r[name]
        # the gradient the optimizer gets, step by step: the loss divisor and
        # the sums over ranks (the optimizers normalize the update, so the
        # trainable alone would hide a gradient off by a constant factor)
        for step, (g, ref) in enumerate(zip(got["grads"], ref_grads)):
            scale = max(float(x.abs().max()) for x in ttrain.tree_leaves(ref))
            ttrain.tree_map(lambda a, b: np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=GRAD_RTOL, atol=GRAD_RTOL * scale,
                err_msg=f"rank {rank} step {step} gradient"), g, ref)
        for step, (m, ref) in enumerate(zip(got["metrics"], ref_metrics)):
            for k in ref:
                np.testing.assert_allclose(m[k], ref[k], rtol=LOSS_RTOL,
                                           err_msg=f"rank {rank} step {step} {k}")
        ttrain.tree_map(lambda a, b: np.testing.assert_allclose(
            a.detach().numpy(), b.detach().numpy(), atol=TREE_ATOL,
            err_msg=f"rank {rank}"), got["trainable"], ref_trainable)
    # the update moved the params (the check is not vacuous)
    moved = [not torch.equal(a, b) for a, b in zip(
        ttrain.tree_leaves(ref_trainable),
        ttrain.tree_leaves(setup["trainable"][setup["cases"][name]["train"]]))]
    assert any(moved)


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c["mode"] == "fsdp"])
def test_fsdp_frees_gathered_tensors_after_use(world, name):
    """FSDP without remat: each forward leaves none of the full tensors it
    gathered alive (autograd keeps their chunks, and the backward gathers
    them again), where with nothing packed it keeps them (the control)."""
    for r in world:
        forwards = r[name]["fsdp_forwards"]
        assert len(forwards) == STEPS * ACCUM
        assert all(held == 0 and regathered > 0 for held, regathered in forwards)
        assert r["fsdp_unpacked"] and all(
            held > 0 and regathered == 0 for held, regathered in r["fsdp_unpacked"])


@pytest.mark.parametrize("name", ["(256, 192)_dim0", "(256, 192)_dim1", "(130, 3, 256)_dim2"])
def test_adafactor_on_chunks_matches_whole_leaves(setup, world, name):
    """Factored moments (d0, d1 either the split axis or not) and the
    block RMS from sums over the chunks; clipping over them."""
    p, grads, _ = setup["adafactor"][name]
    opt = ttrain.Adafactor(1e-2, max_grad_norm=1e-3)
    tree = {"w": torch.from_numpy(p)}
    state = opt.init(tree)
    for g in grads:
        tree, state = opt.update({"w": torch.from_numpy(g)}, state, tree)
    for r in world:
        np.testing.assert_allclose(r["adafactor"][name].numpy(), tree["w"].numpy(),
                                   atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# The CLI as two processes
# ---------------------------------------------------------------------------


def _write_run(tmp_path, params, mode, epochs):
    import yaml

    from avatar_tpu_torch.utils.weight_import import save_single_file_checkpoint

    cond, enc = tmp_path / "cond", tmp_path / "enc"
    ckpt = tmp_path / "base.safetensors"
    if not ckpt.exists():
        rng = np.random.default_rng(7)
        cond.mkdir()
        enc.mkdir()
        for i in range(4):
            np.save(enc / f"c{i}.npy", rng.standard_normal((8, F_, HW, HW)).astype(np.float32))
            np.save(cond / f"c{i}.npy", rng.standard_normal((8, F_, HW, HW)).astype(np.float32))
            np.save(cond / f"c{i}_ref.npy",
                    rng.standard_normal((8, 1, HW, HW)).astype(np.float32))
        save_single_file_checkpoint(ckpt, params, tdit.DiTConfig(**DIT_KW))
    configs = {}
    for run in ("one", "two"):
        cfg = {"checkpoint_path": str(ckpt), "precision": "float32", "train": {
            "condition_latents_dir": str(cond), "encoder_latents_dir": str(enc),
            "output_dir": str(tmp_path / run), "batch_size": 2, "num_epochs": epochs,
            "learning_rate": 1e-3, "lora_rank": 4, "lora_alpha": 4,
            "train_mode": "lora_audio", "log_every_n_steps": 1, "wandb_project": None,
            "rf_log_normal_mu": -0.5, "rf_log_normal_sigma": 1.0,
            "sharding_mode": mode, "mesh_fsdp": 2 if run == "two" else 1}}
        configs[run] = tmp_path / f"{run}.yaml"
        configs[run].write_text(yaml.safe_dump(cfg))
    return configs


def _losses(out_dir):
    lines = (out_dir / "metrics.jsonl").read_text().splitlines()
    return [float(s.split('"train/loss": ')[1].split(",")[0].rstrip("}"))
            for s in lines if '"train/loss"' in s]


def _run_cli(configs, resume):
    """The CLI once in one process and once as two joined by
    ``--coordinator``, side by side."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    port = _free_port()
    base = [sys.executable, "-m", "avatar_tpu_torch.cli.train", "--train_mode",
            "lora_audio", "--device", "cpu"] + ([] if resume else ["--no_resume"])
    procs = [subprocess.Popen(base + ["--config", str(configs["one"])], env=env,
                              cwd=str(REPO), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen(
        base + ["--config", str(configs["two"]), "--coordinator", f"localhost:{port}",
                "--num_processes", "2", "--process_id", str(i)], env=env, cwd=str(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def test_cli_two_processes_match_one(tmp_path, setup):
    """The JAX package's two-process test for the port: ``cli.train`` as two
    gloo processes (``--coordinator``, ``--num_processes``, ``--process_id``,
    fsdp over both) and as one process give the same per-step losses; a
    second call resumes each from its own state (rank 1's under
    ``state/rank_1``) and runs the next epoch alike."""
    _run_cli(_write_run(tmp_path, setup["params"], "fsdp", 1), resume=False)
    one, two = _losses(tmp_path / "one"), _losses(tmp_path / "two")
    assert len(one) == 2 and np.isfinite(one).all()
    np.testing.assert_allclose(two, one, rtol=1e-5)
    assert (tmp_path / "two" / "best_model_epoch_1.safetensors").exists()
    assert (tmp_path / "two" / "state" / "rank_1").is_dir()
    outs = _run_cli(_write_run(tmp_path, setup["params"], "fsdp", 2), resume=True)
    assert "resumed from step 2" in outs[1]
    one, two = _losses(tmp_path / "one"), _losses(tmp_path / "two")
    assert len(one) == 4
    np.testing.assert_allclose(two, one, rtol=1e-5)
