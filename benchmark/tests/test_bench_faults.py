"""Whole runs on the CPU at a tiny size, the look for a card skipped, with
the timed path broken underneath, each held to the committed limits of the
cell it stands in for: ``correct``, as the harness decides it, has to come
out false. The faults a cell without a second card can have: an answer
altered where it is produced, a step that returns its state unchanged, and
half of a batch left out (serving, training). Unbroken, the same runs come
out correct."""

import pytest
import torch

import tiny
from avatar_tpu_torch.pipelines import pipeline
from benchmark.run import correct_of


def correct(rec):
    return correct_of(rec.checks)


@pytest.mark.parametrize("traffic", ["serve-poisson", "render-long"])
@pytest.mark.parametrize("w8a8", [False, True])
def test_unbroken_runs_are_correct(traffic, w8a8):
    rec, _ = tiny.run(traffic, 2**36 + 17, 1.0, w8a8=w8a8)
    assert correct(rec), rec.checks


def _altered(orig):
    def fn(rgb):
        out = orig(rgb).clone()
        out[..., 0, :8, :8] = out[..., 0, :8, :8] ^ 0x40  # one corner of frame 0
        return out
    return fn


@pytest.mark.parametrize("traffic", ["serve-poisson", "render-long"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, traffic):
    monkeypatch.setattr(pipeline, "rgb_to_yuv420", _altered(pipeline.rgb_to_yuv420))
    rec, _ = tiny.run(traffic, 2**36 + 18, 1.0)
    assert not correct(rec), rec.checks


@pytest.mark.parametrize("traffic", ["serve-poisson", "render-long"])
def test_a_step_that_returns_its_state_unchanged(monkeypatch, traffic):
    monkeypatch.setattr(pipeline, "rf_step", lambda sigmas, out, t, sample, **kw: sample)
    rec, _ = tiny.run(traffic, 2**36 + 19, 1.0)
    assert not correct(rec), rec.checks


def test_half_of_a_served_batch_left_out(monkeypatch):
    orig = pipeline.LTXVideoPipeline.__call__
    sizes = []

    def half(self, params, generator, prompt_embeds, *args, **kw):
        out = orig(self, params, generator, prompt_embeds, *args, **kw)
        b = out.shape[0]
        sizes.append(b)
        if b > 1:  # the second half of the rows repeats the first
            out = torch.cat([out[:(b + 1) // 2], out[:b // 2]])
        return out

    monkeypatch.setattr(pipeline.LTXVideoPipeline, "__call__", half)
    rec, _ = tiny.run("serve-poisson", 2**36 + 20, 1.5,
                      mix_update={"rate_per_s": 30.0, "check_requests": 1000})
    assert max(sizes) > 1
    assert not correct(rec), rec.checks


def test_an_unbroken_training_run_is_correct():
    rec, _ = tiny.run("train-full", 2**36 + 21, 0.5)
    assert correct(rec), rec.checks


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_training_step(fault):
    from avatar_tpu_torch.train import train as program
    from benchmark import faults

    saved = program.velocity_loss, program.make_train_step
    try:
        faults.plant(fault)
        rec, _ = tiny.run("train-full", 2**36 + 22, 0.5)
    finally:
        program.velocity_loss, program.make_train_step = saved
    assert not correct(rec), rec.checks
    if fault == "unchanged":
        assert dict((n, v) for n, v, _ in rec.checks)["update_gap"] == pytest.approx(1.0)


def test_a_served_request_s_batch_is_read_from_its_result():
    from benchmark.drivers.serve import _batches

    a = torch.arange(24, dtype=torch.uint8).reshape(4, 6).numpy()
    b = torch.arange(12, dtype=torch.uint8).reshape(2, 6).numpy()
    views = {0: a[0], 1: a[1], 2: a[2], 3: a[3], 4: b[0], 5: b[1]}
    want = {0: (0, 0, 4), 1: (0, 1, 4), 2: (0, 2, 4), 3: (0, 3, 4), 4: (4, 0, 2), 5: (4, 1, 2)}
    assert _batches(views) == want
    with pytest.raises(ValueError):
        _batches({i: v.copy() for i, v in views.items()})
