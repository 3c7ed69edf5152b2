"""The port's prompt enhancement against the JAX package's with stub
caption and chat models (any Hugging Face pair has their interface): the
same templates, and the same prompts for text-to-video, for a first-frame
item (a tensor in the port, an array in the reference) and for items the
enhancement passes over."""

import numpy as np
import pytest
import torch

from avatar_tpu.pipelines.pipeline import ConditioningItem as JItem
from avatar_tpu.utils import prompt_enhance as jpe
from avatar_tpu_torch.pipelines.pipeline import ConditioningItem as TItem
from avatar_tpu_torch.utils import prompt_enhance as tpe


class _Batch(dict):
    def to(self, device):
        assert device == "meta-device"
        return self


class StubCaptioner:
    """A Florence-2 style processor and model: the caption names the
    image's size and mean pixel."""

    device = "meta-device"

    def __call__(self, text, images, return_tensors):
        assert text == "<DETAILED_CAPTION>" and return_tensors == "pt"
        return _Batch(pixels=torch.from_numpy(np.asarray(images, np.float32)))

    def generate(self, pixels=None, input_ids=None, max_new_tokens=0, num_beams=1,
                 do_sample=True, **kw):
        assert not do_sample
        if pixels is not None:
            return torch.tensor([[int(pixels.mean().item() * 100), *pixels.shape[:2]]])
        return torch.cat([input_ids, input_ids.sum(1, keepdim=True) + torch.arange(5)], dim=1)

    def batch_decode(self, ids, skip_special_tokens):
        return [" ".join(str(i) for i in ids[0].tolist())]

    def post_process_generation(self, text, task, image_size):
        return {task: f"a {image_size[0]}x{image_size[1]} frame, code {text}"}


class StubTokenizer:
    def apply_chat_template(self, messages, tokenize, add_generation_prompt):
        assert not tokenize and add_generation_prompt
        return "|".join(f"{m['role']}:{m['content']}" for m in messages)

    def __call__(self, text, return_tensors):
        return _Batch(input_ids=torch.tensor([[ord(c) % 97 for c in text]]))

    def decode(self, ids, skip_special_tokens):
        return "  enhanced " + "".join(chr(65 + i % 26) for i in ids.tolist()) + " "


def _both(prompt, items_j=None, items_t=None):
    cap, tok = StubCaptioner(), StubTokenizer()
    j = jpe.generate_cinematic_prompt(cap, cap, cap, tok, prompt, items_j, max_new_tokens=8)
    t = tpe.generate_cinematic_prompt(cap, cap, cap, tok, prompt, items_t, max_new_tokens=8)
    return j, t


def test_templates_are_the_reference_s():
    assert tpe.T2V_CINEMATIC_PROMPT == jpe.T2V_CINEMATIC_PROMPT
    assert tpe.I2V_CINEMATIC_PROMPT == jpe.I2V_CINEMATIC_PROMPT


@pytest.mark.parametrize("prompt", ["a woman talks", ["a man nods", "two people wave"]])
def test_text_to_video_matches_jax(prompt):
    j, t = _both(prompt)
    assert t == j and len(t) == (1 if isinstance(prompt, str) else 2)
    assert all(p.startswith("enhanced ") for p in t)


def test_first_frame_item_matches_jax():
    media = np.random.default_rng(0).uniform(-1, 1, (2, 9, 12, 16, 3)).astype(np.float32)
    j, t = _both(["a", "b"], [JItem(media, 0, 1.0)], [TItem(torch.from_numpy(media), 0, 1.0)])
    assert t == j and t[0] != t[1]
    np.testing.assert_array_equal(np.asarray(tpe.array_to_pil(media[1, 0])),
                                  np.asarray(jpe.array_to_pil(media[1, 0])))


def test_other_items_return_the_prompts():
    media = np.zeros((1, 9, 8, 8, 3), np.float32)
    for frame, n in ((8, 1), (0, 2)):
        j, t = _both("keep me", [JItem(media, frame, 1.0)] * n,
                     [TItem(torch.from_numpy(media), frame, 1.0)] * n)
        assert t == j == ["keep me"]
