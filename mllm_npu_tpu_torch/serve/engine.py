"""Single-request inference engine (twin of ``InferenceEngine`` in
``mllm_npu_tpu/serve/engine.py:43-195``), comprehension branch: b64 image
→ anyres tiling → ``<patch>…</patch><img>…</img>Question: …\\nAnswer:``
prompt → greedy decode → special-token-stripped text. A null or empty
image means a text-only question. The image-generation branch waits for
the de-tokenizer slice.
"""

from __future__ import annotations

import base64
import io
import re
import numpy as np
import torch
from PIL import Image

from mllm_npu_tpu_torch.constant import (BOI_TOKEN, BOP_TOKEN, EOI_TOKEN,
                                         EOP_TOKEN, NUM_IMG_TOKENS,
                                         image_tokens_str)
from mllm_npu_tpu_torch.data.utils import (
    grid_pinpoints_from_resolution_grids, process_anyres_image)
from mllm_npu_tpu_torch.models.generation.generate import MLLMGenerator
from mllm_npu_tpu_torch.models.generation.sampler import (
    SamplingConfig, ladder_from_tokenizer)
from mllm_npu_tpu_torch.utils.device import resolve_device

DEFAULT_RESOLUTION_GRIDS = ("1x1", "1x2", "1x3", "2x1", "3x1", "1x4",
                            "4x1", "2x2")


class InferenceEngine:
    """``model`` is a ``GeneralizedMultimodalModel``; it is moved to
    ``device`` (``cuda`` unless the caller names another).
    ``quantize_int8`` / ``quantize_int4`` serve its Llama with int8 / int4
    weights (``MLLMGenerator``), converted in place on ``device``."""

    def __init__(self, *, model, tokenizer, image_transform,
                 resolution_grids=DEFAULT_RESOLUTION_GRIDS,
                 base_resolution: int = 448,
                 num_img_in_tokens: int = NUM_IMG_TOKENS,
                 num_img_out_tokens: int = NUM_IMG_TOKENS,
                 max_new_tokens: int = 512, device=None,
                 quantize_int8: bool = False, quantize_int4: bool = False):
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.image_transform = image_transform
        self.base_resolution = base_resolution
        self.grid_pinpoints = grid_pinpoints_from_resolution_grids(
            list(resolution_grids), base_resolution)
        self.num_img_in_tokens = num_img_in_tokens
        self.boi = tokenizer.encode(BOI_TOKEN, add_special_tokens=False)[0]
        self.eoi = tokenizer.encode(EOI_TOKEN, add_special_tokens=False)[0]
        self.bop = tokenizer.encode(BOP_TOKEN, add_special_tokens=False)[0]
        self.eop = tokenizer.encode(EOP_TOKEN, add_special_tokens=False)[0]
        eos = getattr(tokenizer, "eos_token_id", -1)
        self.generator = MLLMGenerator(
            model.to(self.device),
            sampling=SamplingConfig(
                max_new_tokens=max_new_tokens,
                eos_token_id=eos if eos is not None else -1,
                pad_token_id=getattr(tokenizer, "pad_token_id", 0) or 0),
            ladder=ladder_from_tokenizer(tokenizer, num_img_out_tokens),
            quantize_int8=quantize_int8, quantize_int4=quantize_int4)

    def _prepare_comprehension(self, input_text: str, image_b64: str):
        """b64 image + question → (prompt ids, anyres tiles NHWC, tile
        positions, ids_cmp_mask); the last three are None without image."""
        if not image_b64:
            prompt = f"Question: {input_text}\nAnswer:"
            ids = [self.tokenizer.bos_token_id] + self.tokenizer.encode(
                prompt, add_special_tokens=False)
            return np.asarray(ids, np.int32), None, None, None
        image = Image.open(io.BytesIO(
            base64.b64decode(image_b64))).convert("RGB")
        patches, patch_pos = process_anyres_image(
            image, self.image_transform, self.grid_pinpoints,
            self.base_resolution)
        n = patches.shape[0]
        image_tokens = "".join(
            image_tokens_str(self.num_img_in_tokens, BOP_TOKEN, EOP_TOKEN)
            for _ in range(n - 1))
        image_tokens += image_tokens_str(self.num_img_in_tokens)
        prompt = image_tokens + f"Question: {input_text}\nAnswer:"
        ids = np.asarray([self.tokenizer.bos_token_id] + self.tokenizer.encode(
            prompt, add_special_tokens=False), np.int32)
        ids_cmp_mask = np.zeros_like(ids, bool)
        boi_idx = np.where((ids == self.boi) | (ids == self.bop))[0]
        eoi_idx = np.where((ids == self.eoi) | (ids == self.eop))[0]
        for b, e in zip(boi_idx, eoi_idx):
            ids_cmp_mask[b + 1:e] = True
        return ids, patches, patch_pos, ids_cmp_mask

    def _decode_text(self, gen_ids: np.ndarray) -> str:
        pad = self.generator.sampling.pad_token_id
        eos = self.generator.sampling.eos_token_id
        keep = gen_ids != pad
        if eos >= 0:
            hits = np.where(gen_ids == eos)[0]
            if len(hits):
                keep[hits[0]:] = False
        return self.tokenizer.decode(gen_ids[keep], skip_special_tokens=False)

    def _strip_text(self, gen_ids: np.ndarray) -> str:
        text = self._decode_text(gen_ids)
        text = re.sub(r"<[^>]*>", "", text)
        text = re.sub(r"\[(.*)\]", "", text)
        return text.split("\n")[0]

    def generate_ids(self, input_text: str, image_b64: str) -> np.ndarray:
        """Greedy ids [max_new_tokens] for one request."""
        ids, patches, patch_pos, ids_cmp_mask = \
            self._prepare_comprehension(input_text, image_b64)
        dev = self.device
        input_ids = torch.as_tensor(ids, dtype=torch.long, device=dev)[None]
        if patches is None:
            out = self.generator.generate(input_ids)
        else:
            n = patches.shape[0]
            out = self.generator.generate(
                input_ids,
                images=torch.as_tensor(patches, device=dev),
                embeds_cmp_mask=torch.ones((n,), dtype=torch.bool, device=dev),
                ids_cmp_mask=torch.as_tensor(ids_cmp_mask, device=dev)[None],
                patch_positions=torch.as_tensor(patch_pos, device=dev))
        return out["generate_ids"][0].cpu().numpy()

    def comprehension(self, input_text: str, image_b64: str) -> str:
        return self._strip_text(self.generate_ids(input_text, image_b64))
