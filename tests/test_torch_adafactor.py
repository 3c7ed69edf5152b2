"""The port's Adafactor against ``optax.adafactor`` as the JAX package
chains it (``avatar_tpu/train/train.py:make_optimizer``), on the CPU in f32.

The port's leaves are in torch's layout and optax's in JAX's: a linear is
[out, in] against [in, out], a conv [out, in, kt, kh, kw] against [kt, kh,
kw, in, out]. The same gradients go to both (each in its own layout), and
the port's params after each step must be the JAX params in the port's
layout: square, non-square, 1-D and 5-D leaves, factored (two axes of at
least 128) and not, over several steps, with global-norm clipping, a
learning-rate schedule and the EMA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.core.config import TrainConfig as JConfig
from avatar_tpu.train import train as jtrain
from avatar_tpu_torch.core.config import TrainConfig as TConfig
from avatar_tpu_torch.train import train as ttrain
from avatar_tpu_torch.train.checkpoints import TrainStateCheckpointer

torch.set_num_threads(2)

# JAX-layout shapes, and whether optax factors them
LEAVES = {
    "square": ((256, 256), True),
    "wide": ((128, 384), True),
    "tall": ((320, 128), True),
    "narrow": ((64, 256), False),     # second axis below 128: not factored
    "bias": ((256,), False),
    "conv": ((3, 3, 3, 128, 128), True),
    "conv_out": ((1, 3, 3, 128, 48), False),
    "table": ((6, 128), False),
}
# f32 through the same arithmetic: the reductions' summation order is the
# only difference (a few ulps of the moments), and the updates are
# normalised, so the params agree to a few ulps of the update size
ATOL = 2e-6
RTOL = 1e-5


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 2:
        return a.T
    if a.ndim == 5:
        return a.transpose(4, 3, 0, 1, 2)
    return a


def _draw(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(shape)).astype(np.float32)
            for k, (shape, _) in LEAVES.items()}


def _torch_tree(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(_to_torch_layout(v)))
            for k, v in tree.items()}


def _run(cfg_kw, steps=4):
    rng = np.random.default_rng(0)
    params = _draw(rng, 0.05)
    params["bias"] *= 0.0  # a zero leaf: param block rms clamps at 1e-3
    jcfg = JConfig(checkpoint_path="x", optimizer="adafactor", **cfg_kw)
    tcfg = TConfig(checkpoint_path="x", optimizer="adafactor", **cfg_kw)
    jopt, topt = jtrain.make_optimizer(jcfg), ttrain.make_optimizer(tcfg)
    jp = jax.tree.map(jnp.asarray, params)
    tp = _torch_tree(params)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for _ in range(steps):
        grads = _draw(rng, 0.3)
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        tp, tstate = topt.update(_torch_tree(grads), tstate, tp)
        for k in LEAVES:
            np.testing.assert_allclose(tp[k].numpy(), _to_torch_layout(np.asarray(jp[k])),
                                       atol=ATOL, rtol=RTOL, err_msg=k)
    return jstate, tstate, topt, tp


def test_factored_leaves_are_optax_s():
    opt = ttrain.Adafactor(1e-3)
    for name, (shape, factored) in LEAVES.items():
        tshape = _to_torch_layout(np.zeros(shape)).shape
        assert (opt.factored_dims(tshape) is not None) == factored, name


@pytest.mark.parametrize("cfg_kw", [
    dict(learning_rate=1e-2),
    dict(learning_rate=1e-2, max_grad_norm=0.5, lr_schedule="cosine",
         lr_warmup_steps=1, lr_total_steps=6, ema_decay=0.9),
], ids=["plain", "clip_schedule_ema"])
def test_adafactor_matches_optax(cfg_kw):
    jstate, tstate, topt, tp = _run(cfg_kw)
    assert tstate["count"] == 4
    # the factored moments are the JAX ones, transposed the same way
    jfact = jstate[1] if cfg_kw.get("max_grad_norm") else jstate
    while not hasattr(jfact, "v_row"):
        jfact = jfact[0]
    for k, (shape, factored) in LEAVES.items():
        if factored:
            # v_row keeps every axis but out's, v_col every axis but in's:
            # a conv's [kt, kh, kw, in] is the port's [in, kt, kh, kw]
            for name in ("v_row", "v_col"):
                ref = np.asarray(getattr(jfact, name)[k])
                if ref.ndim == 4:
                    ref = ref.transpose(3, 0, 1, 2)
                np.testing.assert_allclose(tstate[name][k].numpy(), ref, rtol=1e-5,
                                           err_msg=f"{k} {name}")
    if cfg_kw.get("ema_decay"):
        jema = jtrain.ema_params(jstate)
        for k in LEAVES:
            np.testing.assert_allclose(ttrain.ema_params(tstate)[k].numpy(),
                                       _to_torch_layout(np.asarray(jema[k])),
                                       atol=ATOL, rtol=RTOL)


def test_adafactor_state_round_trip(tmp_path):
    """The resume state holds the Adafactor moments: a restored run takes
    the same next step as the one that kept going."""
    _, tstate, topt, tp = _run(dict(learning_rate=1e-2, ema_decay=0.9), steps=2)
    ckpt = TrainStateCheckpointer(tmp_path / "state")
    ckpt.save(2, tp, tstate, extra={"epoch": 1})
    step, restored = ckpt.restore()
    assert step == 2 and restored["extra"] == {"epoch": 1}
    grads = _torch_tree(_draw(np.random.default_rng(5), 0.3))
    a, sa = topt.update(grads, tstate, tp)
    b, sb = topt.update(grads, restored["opt_state"], restored["trainable"])
    for k in LEAVES:
        assert torch.equal(a[k], b[k])
        for name in ("v_row", "v_col", "v"):
            assert torch.equal(sa[name][k], sb[name][k])
