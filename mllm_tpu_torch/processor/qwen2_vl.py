"""Qwen2-VL combined processor: chat text + image-pad expansion + patchify.

A copy of `mllm_tpu/processor/qwen2_vl.py` (numpy on the host): tokenize the
chat-templated text, expand each <|image_pad|> to (t*h*w / merge^2) copies,
and emit the patch matrix, the grid and the M-RoPE positions for the vision
tower and the language model.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .image import Qwen2VLImageProcessor

IMAGE_PAD = "<|image_pad|>"
VIDEO_PAD = "<|video_pad|>"
VISION_START = "<|vision_start|>"
VISION_END = "<|vision_end|>"


@dataclass
class Qwen2VLProcessorOutput:
    input_ids: np.ndarray  # [1, S]
    patches: Optional[np.ndarray]  # [Sp, C*tps*ps*ps] or None
    grid_thw: Optional[tuple[int, int, int]]
    position_ids: np.ndarray  # [3, 1, S]
    mrope_delta: int


class Qwen2VLProcessor:
    def __init__(self, tokenizer, image_processor: Optional[Qwen2VLImageProcessor] = None,
                 image_token_id: int = 151655, video_token_id: int = 151656,
                 merge_size: int = 2):
        self.tokenizer = tokenizer
        self.image_processor = image_processor or Qwen2VLImageProcessor()
        self.image_token_id = image_token_id
        self.video_token_id = video_token_id
        self.merge_size = merge_size

    def chat_text(self, prompt: str, n_images: int = 1, video: bool = False) -> str:
        pad = VIDEO_PAD if video else IMAGE_PAD
        img = f"{VISION_START}{pad}{VISION_END}" * n_images
        return (
            "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
            f"<|im_start|>user\n{img}{prompt}<|im_end|>\n"
            "<|im_start|>assistant\n"
        )

    def __call__(self, text: str, images=None, videos=None) -> Qwen2VLProcessorOutput:
        """images: one image (or list treated as frames is NOT implied — use
        `videos` for that).  videos: one video as a list of frames; frames
        stack on the temporal axis, so grid_t = n_frames / temporal_patch_size
        (reference processing_qwen2_vl.hpp:134 `grid_t = batch / tps`) and the
        <|video_pad|> expands to t*h*w/merge^2 tokens."""
        from ..models.qwen2_vl import get_rope_index

        patches = grid = None
        if images is not None and videos is not None:
            raise ValueError("pass one image or one video, not both")
        if images is not None:
            patches, grid = self.image_processor(images)
            n_img_tokens = (grid[0] * grid[1] * grid[2]) // (self.merge_size**2)
            # expand the single pad token to n_img_tokens copies
            text = text.replace(IMAGE_PAD, "<<<IMGPAD>>>")
            text = text.replace("<<<IMGPAD>>>", IMAGE_PAD * n_img_tokens, 1)
        elif videos is not None:
            patches, grid = self.image_processor(list(videos))
            n_vid_tokens = (grid[0] * grid[1] * grid[2]) // (self.merge_size**2)
            text = text.replace(VIDEO_PAD, "<<<VIDPAD>>>")
            text = text.replace("<<<VIDPAD>>>", VIDEO_PAD * n_vid_tokens, 1)
        ids = np.asarray(self.tokenizer.encode(text), np.int32)[None, :]
        pos, delta = get_rope_index(
            ids[0], [grid] if grid else [], self.image_token_id, self.video_token_id,
            self.merge_size,
        )
        return Qwen2VLProcessorOutput(ids, patches, grid, pos[:, None, :].astype(np.int32), delta)
