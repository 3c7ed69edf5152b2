"""Prompt enhancement, cinematic rewriting by an LLM (port of
``avatar_tpu/utils/prompt_enhance.py``; host side, optional).

An image captioner (Florence-2 style) and an instruction-tuned chat model
turn the user's prompt, and for image-to-video the conditioning first
frame's caption, into a cinematic prompt. The caller loads the two models
(any Hugging Face caption / chat pair, on any device: the inputs follow
``model.device``); this module holds the templates and the orchestration.
No inference path calls it.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

T2V_CINEMATIC_PROMPT = """You are an expert cinematic director with many award winning movies, When writing prompts based on the user input, focus on detailed, chronological descriptions of actions and scenes.
Include specific movements, appearances, camera angles, and environmental details - all in a single flowing paragraph.
Start directly with the action, and keep descriptions literal and precise.
Think like a cinematographer describing a shot list.
Do not change the user input intent, just enhance it.
Keep within 150 words.
For best results, build your prompts using this structure:
Start with main action in a single sentence
Add specific details about movements and gestures
Describe character/object appearances precisely
Include background and environment details
Specify camera angles and movements
Describe lighting and colors
Note any changes or sudden events
Do not exceed the 150 word limit!
Output the enhanced prompt only.
"""

I2V_CINEMATIC_PROMPT = """You are an expert cinematic director with many award winning movies, When writing prompts based on the user input, focus on detailed, chronological descriptions of actions and scenes.
Include specific movements, appearances, camera angles, and environmental details - all in a single flowing paragraph.
Start directly with the action, and keep descriptions literal and precise.
Think like a cinematographer describing a shot list.
Keep within 150 words.
For best results, build your prompts using this structure:
Describe the image first and then add the user input. Image description should be in first priority! Align to the image caption if it contradicts the user text input.
Start with main action in a single sentence
Add specific details about movements and gestures
Describe character/object appearances precisely
Include background and environment details
Specify camera angles and movements
Describe lighting and colors
Note any changes or sudden events
Align to the image caption if it contradicts the user text input.
Do not exceed the 150 word limit!
Output the enhanced prompt only.
"""


def array_to_pil(frame: np.ndarray):
    """[H, W, 3] in [-1, 1] -> PIL image."""
    from PIL import Image

    assert frame.min() >= -1.001 and frame.max() <= 1.001
    return Image.fromarray(
        (np.clip((frame + 1) / 2, 0, 1) * 255).astype(np.uint8)
    )


def generate_cinematic_prompt(
    image_caption_model,
    image_caption_processor,
    prompt_enhancer_model,
    prompt_enhancer_tokenizer,
    prompt: Union[str, List[str]],
    conditioning_items: Optional[List] = None,
    max_new_tokens: int = 256,
) -> List[str]:
    """The enhanced prompt of each prompt: text-to-video without
    conditioning items; with one first-frame item (channels-last media [B,
    F, H, W, 3] in [-1, 1], a tensor on any device or an array), each
    prompt beside its sample's first-frame caption; with any other items,
    the prompts as they are."""
    prompts = [prompt] if isinstance(prompt, str) else list(prompt)

    if conditioning_items is None:
        return _chat_enhance(
            prompt_enhancer_model, prompt_enhancer_tokenizer,
            [
                [
                    {"role": "system", "content": T2V_CINEMATIC_PROMPT},
                    {"role": "user", "content": f"user_prompt: {p}"},
                ]
                for p in prompts
            ],
            max_new_tokens,
        )

    if len(conditioning_items) > 1 or conditioning_items[0].media_frame_number != 0:
        logger.warning(
            "prompt enhancement only supports unconditional or first-frame "
            "conditioning items, returning original prompts"
        )
        return prompts

    media = conditioning_items[0].media_item
    if isinstance(media, torch.Tensor):
        media = media.detach().float().cpu().numpy()
    media = np.asarray(media)
    first_frames = [array_to_pil(media[i, 0]) for i in range(media.shape[0])]
    assert len(first_frames) == len(prompts)

    captions = _caption_images(
        image_caption_model, image_caption_processor, first_frames
    )
    return _chat_enhance(
        prompt_enhancer_model, prompt_enhancer_tokenizer,
        [
            [
                {"role": "system", "content": I2V_CINEMATIC_PROMPT},
                {
                    "role": "user",
                    "content": f"user_prompt: {p}\nimage_caption: {c}",
                },
            ]
            for p, c in zip(prompts, captions)
        ],
        max_new_tokens,
    )


def _caption_images(model, processor, images) -> List[str]:
    """Florence-2 style '<DETAILED_CAPTION>' captioning."""
    captions = []
    for image in images:
        inputs = processor(
            text="<DETAILED_CAPTION>", images=image, return_tensors="pt"
        ).to(model.device)
        with torch.no_grad():
            ids = model.generate(
                **inputs, max_new_tokens=1024, num_beams=3, do_sample=False
            )
        text = processor.batch_decode(ids, skip_special_tokens=False)[0]
        parsed = processor.post_process_generation(
            text, task="<DETAILED_CAPTION>",
            image_size=(image.width, image.height),
        )
        captions.append(parsed["<DETAILED_CAPTION>"])
    return captions


def _chat_enhance(model, tokenizer, messages_batch, max_new_tokens) -> List[str]:
    out = []
    for messages in messages_batch:
        text = tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True
        )
        inputs = tokenizer(text, return_tensors="pt").to(model.device)
        with torch.no_grad():
            ids = model.generate(
                **inputs, max_new_tokens=max_new_tokens, do_sample=False
            )
        decoded = tokenizer.decode(
            ids[0][inputs["input_ids"].shape[1]:], skip_special_tokens=True
        )
        out.append(decoded.strip())
    return out
