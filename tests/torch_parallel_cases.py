"""What each rank of the port's gloo test worlds runs (not a test module).

Each function takes (rank, world, payload) inside an initialized gloo
process group (``tests/torch_dist.py``) and returns a dict of results,
the parent's tests compare them with the JAX package and with the port on
one device. Imports torch and the port only.
"""

import numpy as np
import torch

from avatar_tpu_torch.parallel.collectives import chunk_of
from avatar_tpu_torch.parallel.mesh import Mesh


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _local(x, ag, dim):
    return chunk_of(x, ag, dim).contiguous()


def _grads(fn, inputs, cot):
    """(out, grads of sum(out * cot) w.r.t. ``inputs``)."""
    live = [x.detach().clone().requires_grad_() for x in inputs]
    out = fn(*live)
    (out * cot).sum().backward()
    return out.detach(), [x.grad for x in live]


# ---------------------------------------------------------------------------
# Sequence parallelism (world 4)
# ---------------------------------------------------------------------------


def _attention_cases(payload, ag):
    from avatar_tpu_torch.parallel.sequence import (
        ring_attention,
        ring_flash_attention,
        ulysses_attention,
    )

    out = {}
    for name, case in payload["attention"].items():
        q, k, v, cot = (_local(_t(case[n]), ag, 2) for n in ("q", "k", "v", "cot"))
        mask = None if case.get("mask") is None else _local(_t(case["mask"]), ag, 1)
        kind, kw = case["kind"], dict(case.get("kw", {}))
        if kind == "ulysses":
            def fn(q, k, v):
                return ulysses_attention(q, k, v, ag, kv_mask=mask, **kw)
        elif kind == "ring":
            def fn(q, k, v):
                return ring_attention(q, k, v, ag, kv_mask=mask, **kw)
        else:
            def fn(q, k, v):
                return ring_flash_attention(q, k, v, ag, kv_mask=mask, **kw)
        o, (dq, dk, dv) = _grads(fn, [q, k, v], cot)
        out[name] = {"out": o, "dq": dq, "dk": dk, "dv": dv}
    return out


def _dit_sp_cases(payload, meshes):
    from avatar_tpu_torch.models import dit as tdit
    from avatar_tpu_torch.parallel.sequence import dit_apply_sp

    cfg = tdit.DiTConfig(**payload["dit_cfg"])
    params = tdit.permute_dit_params_for_split_rope(payload["dit_params"], cfg)
    x = payload["dit_inputs"]
    out = {}
    for name, case in payload["dit"].items():
        mesh = meshes[case["mesh"]]
        slm = None if case.get("skip_layer_mask") is None else _t(case["skip_layer_mask"])
        strategy = (None if case.get("strategy") is None
                    else tdit.SkipLayerStrategy[case["strategy"]])
        with torch.no_grad():
            out[name] = dit_apply_sp(
                params, cfg, _t(x["tokens"]), _t(x["grid"]), _t(case["t"]), _t(x["text"]),
                _t(x["mask"]), mesh=mesh, sp_impl=case["sp_impl"],
                data_axis=case.get("data_axis"), attention_impl=case["impl"],
                rope_split=True, skip_layer_mask=slm, skip_layer_strategy=strategy)
    return out


def sequence(rank, world, payload):
    sp_mesh = Mesh(np.arange(world), ("sp",))
    dsp_mesh = Mesh(np.arange(world).reshape(2, world // 2), ("data", "sp"))
    out = {"attention": _attention_cases(payload, sp_mesh.group("sp"))}
    out["dit"] = _dit_sp_cases(payload, {"sp": sp_mesh, "data_sp": dsp_mesh})
    return out


# ---------------------------------------------------------------------------
# Pipeline parallelism (world 4)
# ---------------------------------------------------------------------------


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_t(v) for v in tree]
    return _t(tree) if isinstance(tree, np.ndarray) else tree


def pipeline(rank, world, payload):
    from avatar_tpu_torch.models import dit as tdit
    from avatar_tpu_torch.parallel.collectives import psum_plain
    from avatar_tpu_torch.parallel.pipeline import (
        dit_apply_pp,
        make_pp_mesh,
        stack_block_params,
        unstack_block_params,
    )
    from avatar_tpu_torch.train.train import tree_map

    meshes = {"pp4": make_pp_mesh(pp=4, data=1), "pp2_data2": make_pp_mesh(pp=2, data=2)}
    cfg = tdit.DiTConfig(**payload["dit_cfg"])
    params = payload["dit_params"]
    stacked = dict(params, blocks=stack_block_params(params["blocks"]))
    x = _tree_t(payload["inputs"])
    out = {}
    for name, case in payload["cases"].items():
        mesh = meshes[case["mesh"]]
        kw = dict(mesh=mesh, num_microbatches=case.get("microbatches"),
                  data_axis="data" if case["mesh"] == "pp2_data2" else None,
                  attention_impl=case["impl"], rope_split=False,
                  remat=case.get("remat", False))
        t = _t(case["t"])
        if case.get("skip_layer_mask") is not None:
            kw.update(skip_layer_mask=_t(case["skip_layer_mask"]),
                      skip_layer_strategy=tdit.SkipLayerStrategy[case["strategy"]])
        lora = None
        if case.get("lora") is not None:
            lora = {"blocks": stack_block_params(_tree_t(case["lora"])["blocks"])}
            kw.update(lora=lora, lora_scale=0.5)
        if case.get("hoisted"):
            kw["cross_kv"], _ = tdit.precompute_cross_attention_kv(
                stacked, cfg, x["text"], lora=lora, lora_scale=0.5)
        if not case.get("grad"):
            with torch.no_grad():
                out[name] = dit_apply_pp(stacked, cfg, x["tokens"], x["grid"], t, x["text"],
                                         x["mask"], **kw)
            continue
        # gradients: every rank holds the whole output and loss; each
        # differentiates loss / world and the gradients are summed over the
        # ranks that hold the same leaf (the train step's rule)
        live = tree_map(lambda p: p.detach().clone().requires_grad_(), stacked)
        y = dit_apply_pp(live, cfg, x["tokens"], x["grid"], t, x["text"], x["mask"], **kw)
        loss = torch.mean((y - x["target"]) ** 2)
        (loss / world).backward()
        everyone = mesh.group(mesh.axis_names)
        data = mesh.group("data")
        pg = mesh.group("pp")
        def grad(p):
            return torch.zeros_like(p) if p.grad is None else p.grad

        grads = {k: tree_map(lambda p: psum_plain(grad(p), everyone), v)
                 for k, v in live.items() if k != "blocks"}
        # the stage's blocks hold the gradient of its layers only
        per = cfg.num_layers // pg.size
        stage_grads = tree_map(
            lambda p: psum_plain(grad(p)[pg.index * per:(pg.index + 1) * per], data),
            live["blocks"])
        grads["blocks"] = unstack_block_params(stage_grads)
        grads["stage"] = pg.index
        out[name] = {"loss": loss.detach(), "grads": grads}
    return out


# ---------------------------------------------------------------------------
# The sharded train step (world 2)
# ---------------------------------------------------------------------------


def train_mesh(mode, world):
    from avatar_tpu_torch.parallel.mesh import make_mesh
    from avatar_tpu_torch.parallel.pipeline import make_pp_mesh

    if mode in ("dp",):
        return make_mesh(data=world)
    if mode in ("zero2", "fsdp"):
        return make_mesh(data=1, fsdp=world)
    if mode == "sp":
        return Mesh(np.arange(world).reshape(1, world), ("data", "sp"))
    return make_pp_mesh(pp=world, data=1)


def capture_gradients(optimizer):
    """The list that each ``optimizer.update`` call appends its gradient
    tree to (this rank's summed share, as the optimizer gets it)."""
    grads, update = [], optimizer.update

    def capturing(g, state, params, shard=None):
        grads.append(g)
        return update(g, state, params, shard)

    optimizer.update = capturing
    return grads


def _record_fsdp_forwards(forwards):
    """Make every ``FsdpGather`` append to ``forwards``, for each forward it
    wraps, [the full tensors it gathered that are alive when the forward
    ends (those autograd keeps for the backward), the saved tensors its
    backward gathers again]."""
    from avatar_tpu_torch.train.train import FsdpGather

    exit_, unpack = FsdpGather.__exit__, FsdpGather._unpack

    def recording_exit(self, *exc):
        out = exit_(self, *exc)
        self.record = [len(self._buffers), 0]
        forwards.append(self.record)
        return out

    def counting_unpack(self, packed):
        if not torch.is_tensor(packed):
            self.record[1] += 1
        return unpack(self, packed)

    FsdpGather.__exit__ = recording_exit
    FsdpGather._unpack = counting_unpack


def train(rank, world, payload):
    from avatar_tpu_torch.core.config import TrainConfig
    from avatar_tpu_torch.models import dit as tdit
    from avatar_tpu_torch.train.train import TrainSharding, make_optimizer, make_train_step

    dcfg = tdit.DiTConfig(**payload["dit_cfg"])
    out = {}
    forwards = []
    _record_fsdp_forwards(forwards)
    for name, case in payload["cases"].items():
        forwards.clear()
        cfg = TrainConfig(**case["cfg"])
        mesh = train_mesh(case["mode"], world)
        sharding = TrainSharding(mesh, case["mode"], min_size=case.get("min_size"))
        params = payload["params_split"] if case["rope_split"] else payload["params"]
        dit_params, trainable = sharding.place(params, payload["trainable"][case["train"]])
        optimizer = make_optimizer(cfg)
        grads = capture_gradients(optimizer)
        state = sharding.init_optimizer(optimizer, trainable)
        step = make_train_step(dcfg, cfg, optimizer, attention_impl=case["impl"],
                               rope_split=case["rope_split"], sharding=sharding)
        batch = {k: sharding.rows(_t(v), 1) for k, v in payload["batch"].items()}
        gen = torch.Generator().manual_seed(payload["seed"])
        # "fed": per step the whole batch's t and noise (the JAX step's draws)
        fed = case.get("fed") or [(None, None)] * payload["steps"]
        losses = []
        for t, noise in fed:
            trainable, state, metrics = step(
                trainable, state, dit_params, batch, _t(payload["embeds"]),
                _t(payload["mask"]), gen, t=None if t is None else _t(t),
                noise=None if noise is None else _t(noise))
            losses.append({k: float(v) for k, v in metrics.items()})
        out[name] = {"metrics": losses, "trainable": sharding.full_tree(trainable),
                     "grads": [sharding.full_tree(g, held_as="state") for g in grads],
                     "fsdp_forwards": [tuple(f) for f in forwards]}
    if "adafactor" in payload:
        out["adafactor"] = adafactor_shards(rank, world, payload,
                                            train_mesh("zero2", world).group("fsdp"))
    if "fsdp_control" in payload:
        out["fsdp_unpacked"] = _fsdp_unpacked(world, payload, forwards)
    return out


def _fsdp_unpacked(world, payload, forwards):
    """The control of the FSDP cases: one step of ``payload["fsdp_control"]``
    with nothing packed, so that autograd keeps the gathered tensors."""
    from avatar_tpu_torch.core.config import TrainConfig
    from avatar_tpu_torch.models import dit as tdit
    from avatar_tpu_torch.train.train import (
        FsdpGather,
        TrainSharding,
        make_optimizer,
        make_train_step,
    )

    dcfg = tdit.DiTConfig(**payload["dit_cfg"])
    pack = FsdpGather._pack
    FsdpGather._pack = lambda self, t: t
    try:
        forwards.clear()
        case = payload["cases"][payload["fsdp_control"]]
        cfg = TrainConfig(**case["cfg"])
        sharding = TrainSharding(train_mesh("fsdp", world), "fsdp", min_size=case["min_size"])
        dit_params, trainable = sharding.place(payload["params_split"],
                                               payload["trainable"]["lora"])
        optimizer = make_optimizer(cfg)
        step = make_train_step(dcfg, cfg, optimizer, rope_split=True, sharding=sharding)
        step(trainable, sharding.init_optimizer(optimizer, trainable), dit_params,
             {k: sharding.rows(_t(v), 1) for k, v in payload["batch"].items()},
             _t(payload["embeds"]), _t(payload["mask"]), torch.Generator().manual_seed(0))
        return [tuple(f) for f in forwards]
    finally:
        FsdpGather._pack = pack


def adafactor_shards(rank, world, payload, group):
    """Adafactor on leaves split along each dim (ZeRO's chunks), two steps,
    the chunks gathered back."""
    from avatar_tpu_torch.parallel.collectives import all_gather_plain
    from avatar_tpu_torch.train.train import Adafactor, LeafShard

    out = {}
    for name, (p, grads, dim) in payload["adafactor"].items():
        opt = Adafactor(1e-2, max_grad_norm=1e-3)
        p, grads = _t(p), [_t(g) for g in grads]
        shard = [LeafShard(dim, p.shape, group)]
        local = {"w": _local(p, group, dim)}
        state = opt.init(local, shard)
        for g in grads:
            local, state = opt.update({"w": _local(g, group, dim)}, state, local, shard)
        out[name] = all_gather_plain(local["w"], group, dim)
    return out


# ---------------------------------------------------------------------------
# The multi-device pipeline and server (world 2)
# ---------------------------------------------------------------------------


def tiny_pipeline(**ctor):
    """The serving tests' tiny f32 pipeline (``tests/test_torch_serving.py``)
    with heads of 16, made the same way in every process."""
    import dataclasses

    from avatar_tpu_torch.diffusion.rf import RectifiedFlowSchedule
    from avatar_tpu_torch.models import dit as tdit
    from avatar_tpu_torch.models import vae as tvae
    from avatar_tpu_torch.pipelines import LTXVideoPipeline

    vae_cfg = dataclasses.replace(tvae.demo_config(latent_channels=8), base_channels=32,
                                  decoder_base_channels=32)
    dit_cfg = tdit.DiTConfig(num_attention_heads=2, attention_head_dim=16, in_channels=8,
                             out_channels=8, num_layers=2, cross_attention_dim=32,
                             caption_channels=32)
    return LTXVideoPipeline(
        dit_cfg, tdit.init_dit(dit_cfg, seed=1, device="cpu"),
        vae_cfg, tvae.init_vae(vae_cfg, seed=0, device="cpu"),
        schedule=RectifiedFlowSchedule.create(sampler="Uniform", shifting="SD3",
                                              target_shift_terminal=0.1),
        device="cpu", **ctor)


def generation_meshes(world):
    from avatar_tpu_torch.parallel.pipeline import make_pp_mesh

    return {"dp": dict(dp_mesh=Mesh(np.arange(world), ("data",))),
            "sp_ulysses": dict(sp_mesh=Mesh(np.arange(world), ("sp",))),
            "sp_ring": dict(sp_mesh=Mesh(np.arange(world), ("sp",)), sp_impl="ring"),
            "pp": dict(pp_mesh=make_pp_mesh(pp=world, data=1))}


def weights_pipeline(weights, **ctor):
    """A pipeline on the JAX-layout numpy trees of ``weights`` ({"dit_cfg",
    "dit", "vae"}, the VAE ``tiny_pipeline``'s config), attention "xla"."""
    import dataclasses

    from avatar_tpu_torch.models import dit as tdit
    from avatar_tpu_torch.models import vae as tvae
    from avatar_tpu_torch.pipelines import LTXVideoPipeline
    from avatar_tpu_torch.utils.weight_import import dit_params_from_numpy, vae_params_from_numpy

    vae_cfg = dataclasses.replace(tvae.demo_config(latent_channels=8), base_channels=32,
                                  decoder_base_channels=32)
    dit_cfg = tdit.DiTConfig(**weights["dit_cfg"])
    return LTXVideoPipeline(
        dit_cfg, dit_params_from_numpy(weights["dit"], dit_cfg, device="cpu"), vae_cfg,
        vae_params_from_numpy(weights["vae"], vae_cfg, device="cpu"), attention_impl="xla",
        device="cpu", **ctor)


def generate(pipe, case):
    from avatar_tpu_torch.pipelines import GenerationParams

    p = GenerationParams(**case["params"])
    gen = torch.Generator().manual_seed(case["seed"])
    # a negative prompt with kept keys: a caption with none kept gets 0 from
    # the kernels and uniform attention from the plain path, and the
    # sequence-parallel cross-attention (head-major, as in the JAX package)
    # may take the other one at these lengths
    media = {k: _t(case[k]) for k in ("ref_image", "pose_frames", "negative_prompt_embeds",
                                      "negative_prompt_attention_mask", "ref_latents",
                                      "pose_latents", "init_noise") if k in case}
    with torch.no_grad():
        return pipe(p, gen, _t(case["embeds"]), _t(case["mask"]),
                    output_type=case["output_type"], dtype=torch.float32, **media)


def generation(rank, world, payload):
    from avatar_tpu_torch.pipelines import AvatarServer, GenerationParams, GenerationRequest

    meshes = generation_meshes(world)
    out = {}
    for name, case in payload["cases"].items():
        if case.get("jax_weights"):
            pipe = weights_pipeline(payload["weights"], **meshes[case["mesh"]])
        else:
            pipe = tiny_pipeline(**meshes[case["mesh"]])
        out[name] = generate(pipe, case)
    # the server over a dp pipeline: 3 requests, one batch padded to 4
    pipe = tiny_pipeline(**meshes["dp"])
    server = AvatarServer(pipe, max_batch=4, batch_window_s=2.0)
    try:
        futs = [server.submit(GenerationRequest(
            params=GenerationParams(**r["params"]), prompt_embeds=r["embeds"],
            prompt_attention_mask=r["mask"], ref_image=r["ref_image"],
            pose_frames=r["pose_frames"], seed=r["seed"], output_type="np"))
            for r in payload["requests"]]
        out["served"] = [f.result(timeout=120) for f in futs]
        out["server_stats"] = dict(server.stats)
    finally:
        server.shutdown()
    return out


# ---------------------------------------------------------------------------
# Tensor parallelism (world 2)
# ---------------------------------------------------------------------------


def tensor(rank, world, payload):
    from avatar_tpu_torch.models import dit as tdit
    from avatar_tpu_torch.parallel.mesh import dit_apply_tp, make_mesh, shard_dit_params_tp

    mesh = make_mesh(data=1, fsdp=1, tp=world)
    cfg = tdit.DiTConfig(**payload["dit_cfg"])
    x = _tree_t(payload["inputs"])
    out = {}
    for name, case in payload["cases"].items():
        local = shard_dit_params_tp(payload["dit_params"], cfg, mesh, rope_split=case["split"])
        kw = {}
        if case.get("strategy"):
            kw = dict(skip_layer_mask=_t(case["skip_layer_mask"]),
                      skip_layer_strategy=tdit.SkipLayerStrategy[case["strategy"]])
        out[name] = dit_apply_tp(local, cfg, x["tokens"], x["grid"], _t(case["t"]), x["text"],
                                 x["mask"], mesh=mesh, rope_split=case["split"],
                                 attention_impl=case["impl"], **kw)
        out[name + "_heads"] = local["blocks"][0]["attn1"]["to_q"]["weight"].shape[0]
    return out
