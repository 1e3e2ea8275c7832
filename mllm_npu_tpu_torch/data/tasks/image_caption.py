"""Image-caption task pipeline (webdataset tars → static batches): the
port's copy of ``mllm_npu_tpu/data/tasks/image_caption.py`` (the native
JPEG decode, ``MLLM_TPU_NATIVE_DECODE``, is not ported; images decode with
PIL).

Capability parity with the reference task (data/tasks/image_caption.py):
- wds decode: .txt caption / .jpg image / .json metadata, with
  min-resolution + aspect-ratio gates (:443-455)
- optional generation-prompt templating (prompt + response pools,
  :45-105)
- ``encode_caption_input_ids`` (v1, single image, :167-255) and ``_v2``
  (anyres patches with <patch>…</patch> spans, :258-370): builds
  input_ids + labels + the four masks, choosing the img-first
  (comprehension) or img-last (generation) branch by ``img_first_ratio``
- CLIP-similarity filtering from metadata
- weighted batch assembly via collate_static (fixed shapes for jit)
"""

from __future__ import annotations

import io
import logging
import random
from typing import Optional

import numpy as np
from PIL import Image

from mllm_npu_tpu_torch.constant import (BOP_TOKEN, EOP_TOKEN,
                                         IGNORE_INDEX, image_tokens_str)
from mllm_npu_tpu_torch.data import streams
from mllm_npu_tpu_torch.data.data_utils import (filter_data_with_similarity,
                                                select, unwarp_data)
from mllm_npu_tpu_torch.data.utils import (
    collate_static, grid_pinpoints_from_resolution_grids, pack_samples,
    process_anyres_image)

log = logging.getLogger(__name__)

# generation-prompt pools (same mechanism as the reference's
# gen_prompt_all/gen_prompt_response_all pairs, image_caption.py:45-105)
GEN_PROMPTS = [
    "Please generate an image of",
    "Please create a picture of",
    "Show me a photo of",
    "Draw an illustration of",
    "Produce a picture of",
    "Render an image of",
    "Can you generate a picture of",
    "Can you paint an image of",
    "I want to see an image of",
    "I'd like to view a drawing of",
    "Make a photograph of",
    "Generate an image:",
    "Generate a picture:",
    "Draw a painting:",
    "Sketch a picture of",
    "Compose a visual of",
]
GEN_PROMPT_RESPONSES = [
    "Here is the generated image.",
    "Here is the picture you asked for.",
    "Sure, here is a photo.",
    "Here is the illustration.",
    "Here is the picture.",
    "Here is the rendered image.",
    "Of course, here is the picture.",
    "Certainly, here is the painting.",
    "Here is the image you wanted.",
    "Here is the drawing.",
    "Here is the photograph.",
    "Here is an image.",
    "Here is a picture.",
    "Here is a painting.",
    "Here is the sketch.",
    "Here is the visual.",
]


def encode_caption_input_ids(caption: str, tokenizer, img_first_ratio: float,
                             max_length: int, num_img_in_tokens: int = 64,
                             num_img_out_tokens: int = 64,
                             rng: Optional[random.Random] = None) -> dict:
    """Single-image encode (reference image_caption.py:167-255)."""
    rng = rng or random
    caption_ids = tokenizer.encode(caption, add_special_tokens=False)
    img_first = rng.uniform(0, 1) < img_first_ratio
    if len(caption_ids) + num_img_out_tokens + 4 > max_length:
        img_first = True

    if img_first:
        image_ids = tokenizer.encode(image_tokens_str(num_img_in_tokens),
                                     add_special_tokens=False)
        input_ids = ([tokenizer.bos_token_id] + image_ids + caption_ids
                     + [tokenizer.eos_token_id])
        labels = ([IGNORE_INDEX] + [IGNORE_INDEX] * len(image_ids)
                  + caption_ids + [tokenizer.eos_token_id])
        ids_gen_mask = [False] * len(input_ids)
        ids_cmp_mask = ([False, False] + [True] * num_img_in_tokens
                        + [False] + [False] * len(caption_ids) + [False])
        embeds_gen_mask, embeds_cmp_mask = False, True
    else:
        image_ids = tokenizer.encode(image_tokens_str(num_img_out_tokens),
                                     add_special_tokens=False)
        image_labels = [image_ids[0]] + [IGNORE_INDEX] * (len(image_ids) - 1)
        input_ids = ([tokenizer.bos_token_id] + caption_ids + image_ids
                     + [tokenizer.eos_token_id])
        labels = ([IGNORE_INDEX] * (len(caption_ids) + 1) + image_labels
                  + [tokenizer.eos_token_id])
        ids_gen_mask = ([False] + [False] * len(caption_ids) + [False]
                        + [True] * num_img_out_tokens + [False, False])
        ids_cmp_mask = [False] * len(input_ids)
        embeds_gen_mask, embeds_cmp_mask = True, False

    return _pad_and_pack(input_ids, labels, ids_gen_mask, ids_cmp_mask,
                         embeds_gen_mask, embeds_cmp_mask, tokenizer,
                         max_length)


def encode_caption_input_ids_v2(caption: str, response: str, tokenizer,
                                turn_sep: str, img_first_ratio: float,
                                max_length: int,
                                num_img_in_tokens: int = 64,
                                num_img_out_tokens: int = 64,
                                patch_length: int = 1,
                                rng: Optional[random.Random] = None) -> dict:
    """Anyres encode: patch_length-1 <patch> spans + one <img> span
    (reference image_caption.py:258-370)."""
    rng = rng or random
    caption_ids = tokenizer.encode(caption, add_special_tokens=False)
    response_ids = tokenizer.encode(response, add_special_tokens=False)
    img_first = rng.uniform(0, 1) < img_first_ratio

    if img_first:
        image_tokens = "".join(
            image_tokens_str(num_img_in_tokens, BOP_TOKEN, EOP_TOKEN)
            for _ in range(patch_length - 1))
        image_tokens += image_tokens_str(num_img_in_tokens)
        image_ids = tokenizer.encode(image_tokens, add_special_tokens=False)
        input_ids = ([tokenizer.bos_token_id] + image_ids + caption_ids
                     + [tokenizer.eos_token_id])
        labels = ([IGNORE_INDEX] + [IGNORE_INDEX] * len(image_ids)
                  + caption_ids + [tokenizer.eos_token_id])
        ids_gen_mask = [False] * len(input_ids)
        ids_cmp_mask = [False]
        for _ in range(patch_length):
            ids_cmp_mask += [False] + [True] * num_img_in_tokens + [False]
        ids_cmp_mask += [False] * len(caption_ids) + [False]
        embeds_gen_mask = [False] * patch_length
        embeds_cmp_mask = [True] * patch_length
    else:
        image_ids = tokenizer.encode(image_tokens_str(num_img_out_tokens),
                                     add_special_tokens=False)
        image_labels = [image_ids[0]] + [IGNORE_INDEX] * (len(image_ids) - 1)
        sep_ids = tokenizer.encode(turn_sep, add_special_tokens=False)
        input_ids = ([tokenizer.bos_token_id] + caption_ids + response_ids
                     + image_ids + sep_ids + [tokenizer.eos_token_id])
        labels = ([IGNORE_INDEX] + [IGNORE_INDEX] * len(caption_ids)
                  + response_ids + image_labels + sep_ids
                  + [tokenizer.eos_token_id])
        ids_gen_mask = ([False] + [False] * len(caption_ids)
                        + [False] * len(response_ids) + [False]
                        + [True] * num_img_out_tokens + [False, False]
                        + [False] * len(sep_ids))
        ids_gen_mask = ids_gen_mask[:len(input_ids)]
        ids_cmp_mask = [False] * len(input_ids)
        embeds_gen_mask = [False] * (patch_length - 1) + [True]
        embeds_cmp_mask = [False] * patch_length

    if len(input_ids) >= max_length:
        return {}
    return _pad_and_pack(input_ids, labels, ids_gen_mask, ids_cmp_mask,
                         np.asarray(embeds_gen_mask, bool),
                         np.asarray(embeds_cmp_mask, bool), tokenizer,
                         max_length)


def _pad_and_pack(input_ids, labels, ids_gen_mask, ids_cmp_mask,
                  embeds_gen_mask, embeds_cmp_mask, tokenizer,
                  max_length) -> dict:
    attention_mask = [1] * len(input_ids)
    if len(input_ids) >= max_length:
        input_ids = input_ids[:max_length]
        attention_mask = attention_mask[:max_length]
        labels = labels[:max_length]
        ids_gen_mask = ids_gen_mask[:max_length]
        ids_cmp_mask = ids_cmp_mask[:max_length]
    else:
        pad = max_length - len(input_ids)
        input_ids = input_ids + [tokenizer.pad_token_id] * pad
        attention_mask = attention_mask + [0] * pad
        labels = labels + [IGNORE_INDEX] * pad
        ids_gen_mask = list(ids_gen_mask) + [False] * pad
        ids_cmp_mask = list(ids_cmp_mask) + [False] * pad
    return {
        "input_ids": np.asarray(input_ids, np.int32),
        "attention_mask": np.asarray(attention_mask, np.int32),
        "labels": np.asarray(labels, np.int32),
        "ids_gen_mask": np.asarray(ids_gen_mask, bool),
        "ids_cmp_mask": np.asarray(ids_cmp_mask, bool),
        "embeds_gen_mask": np.asarray(embeds_gen_mask, bool),
        "embeds_cmp_mask": np.asarray(embeds_cmp_mask, bool),
    }


def tokenize_text(data: dict, tokenizer, turn_sep="\n",
                  img_first_ratio=0.5, max_length=128,
                  num_img_in_tokens=64, num_img_out_tokens=64,
                  rng: Optional[random.Random] = None) -> dict:
    """Anyres-aware late tokenization (reference image_caption.py:108-164)."""
    if "images" not in data:
        patches = 1
    elif "images_patch_length" in data:
        patches = int(np.asarray(data["images_patch_length"]).reshape(-1)[0])
    else:
        patches = 1
    if "text" not in data:
        return data
    if patches * (num_img_in_tokens + 2) + 2 > max_length:
        data.pop("text")
        log.info("sample with %d patches exceeds max length %d", patches,
                 max_length)
        return data
    results = encode_caption_input_ids_v2(
        caption=data["text"], response=data.get("response", ""),
        tokenizer=tokenizer, turn_sep=turn_sep,
        img_first_ratio=img_first_ratio, max_length=max_length,
        num_img_in_tokens=num_img_in_tokens,
        num_img_out_tokens=num_img_out_tokens, patch_length=patches,
        rng=rng)
    if not results.get("input_ids", np.zeros(0)).size:
        data.pop("text")
        return data
    data.update(results)
    return data


def decode_image_text_pair(sample: dict, tokenizer, image_transform=None,
                           max_length=128, use_caption_in_metadata=False,
                           instruction_prompt=None, add_gen_prompt=False,
                           caption_key_in_metadata="", min_resolution=400,
                           min_aspect_ratio=0.666, img_first_ratio=0.5,
                           num_img_in_tokens=64, num_img_out_tokens=64,
                           assure_text=True, multi_resolution=False,
                           grid_pinpoints=None, base_resolution=224,
                           rng: Optional[random.Random] = None) -> dict:
    """Decode one grouped wds sample {'.txt': bytes, '.jpg': bytes,
    '.json': bytes} (reference image_caption.py:376-538, regrouped)."""
    rng = rng or random
    out = {}
    import json as _json

    caption = None
    if assure_text:
        if not use_caption_in_metadata and ".txt" in sample:
            caption = sample[".txt"].decode("utf-8")
        elif use_caption_in_metadata and ".json" in sample:
            try:
                meta = _json.loads(sample[".json"].decode("utf-8"))
                caption = meta.get(caption_key_in_metadata)
            except Exception:  # noqa: BLE001
                caption = None

    if caption is not None:
        response = ""
        if add_gen_prompt:
            i = rng.randrange(len(GEN_PROMPTS))
            caption = GEN_PROMPTS[i] + " " + caption.lstrip(" ")
            response = GEN_PROMPT_RESPONSES[i]
        if instruction_prompt is not None:
            caption = instruction_prompt.format_map({"instruction": caption})
        out["text"] = caption
        out["response"] = response

    for ext in (".jpg", ".jpeg", ".png"):
        if ext in sample:
            try:
                image = Image.open(io.BytesIO(sample[ext])).convert("RGB")
            except Exception as e:  # noqa: BLE001
                log.warning("bad image skipped: %s", e)
                break
            w, h = image.size
            if h < min_resolution or w < min_resolution:
                break
            ar = h / w
            if ar < min_aspect_ratio or ar > 1 / min_aspect_ratio:
                break
            if multi_resolution:
                imgs, pos = process_anyres_image(
                    image, image_transform, grid_pinpoints, base_resolution)
                out.update({
                    "images": imgs,
                    "images_patch_length": np.asarray([imgs.shape[0]]),
                    "patch_position": pos,
                    "image_size": np.asarray([image.size]),
                })
            else:
                out["images"] = (image_transform(image)
                                 if image_transform else image)
            break

    if ".json" in sample and not use_caption_in_metadata:
        try:
            out["metadata"] = sample[".json"].decode("utf-8")
        except Exception:  # noqa: BLE001
            pass
    out.setdefault("metadata", "{}")
    return out


def build_caption_datapipes_with_pixels(
        data_dir, tokenizer=None, max_length=77, batch_size=None,
        similarity_thr=0.2, min_resolution=180, image_transform=None,
        min_aspect_ratio=0.666, use_caption_in_metadata=False,
        instruction_prompt=None, turn_sep="\n", add_gen_prompt=False,
        caption_key_in_metadata="top_caption", img_first_ratio=0.5,
        num_img_in_tokens=64, num_img_out_tokens=64, assure_text=True,
        cycle_count=None, multi_resolution=False, resolution_grids=None,
        base_resolution=224, dataset_name=None, max_images_per_batch=None,
        seed=888, shard_for_host=True, packing=False, **kw):
    """Checkpointable pipeline equivalent of the reference builder
    (image_caption.py:540-641). Yields per-sample dicts; with batch_size,
    yields static collated batches. Returns a resumable stream (see
    streams.SampleStream) whose state is {"file_idx", "pos"}."""
    grid_pinpoints = []
    if multi_resolution:
        grid_pinpoints = grid_pinpoints_from_resolution_grids(
            list(resolution_grids), base_resolution)

    def list_files():
        files = streams.list_files(data_dir, "*.tar")
        return streams.shard_for_host(files) if shard_for_host else files

    def records(tar_path, _fi):
        return streams.group_webdataset(streams.iter_tar_members(tar_path))

    def decode(grouped, rng):
        data = decode_image_text_pair(
            grouped, tokenizer, image_transform=image_transform,
            max_length=max_length,
            use_caption_in_metadata=use_caption_in_metadata,
            instruction_prompt=instruction_prompt,
            add_gen_prompt=add_gen_prompt,
            caption_key_in_metadata=caption_key_in_metadata,
            min_resolution=min_resolution,
            min_aspect_ratio=min_aspect_ratio,
            img_first_ratio=img_first_ratio,
            num_img_in_tokens=num_img_in_tokens,
            num_img_out_tokens=num_img_out_tokens,
            assure_text=assure_text,
            multi_resolution=multi_resolution,
            grid_pinpoints=grid_pinpoints,
            base_resolution=base_resolution, rng=rng)
        data = unwarp_data({"data": data})
        if multi_resolution:
            data = tokenize_text(
                data, tokenizer, turn_sep=turn_sep,
                img_first_ratio=img_first_ratio,
                max_length=max_length,
                num_img_in_tokens=num_img_in_tokens,
                num_img_out_tokens=num_img_out_tokens, rng=rng)
        elif "text" in data and "input_ids" not in data:
            enc = encode_caption_input_ids(
                data["text"], tokenizer,
                img_first_ratio=img_first_ratio,
                max_length=max_length,
                num_img_in_tokens=num_img_in_tokens,
                num_img_out_tokens=num_img_out_tokens, rng=rng)
            data.update(enc)
        if not filter_data_with_similarity(
                data, similarity_thr, assure_text):
            return None
        if "input_ids" not in data:
            return None
        return select(data)

    stream = streams.SampleStream(list_files, records, decode, seed=seed,
                                  cycle_count=cycle_count)
    if batch_size is None:
        return stream

    # the transform resizes every patch to its own output size
    img_size = getattr(image_transform, "image_size", base_resolution)
    max_patches = 1
    if multi_resolution:
        max_patches = 1 + max(
            (g[0] // base_resolution) * (g[1] // base_resolution)
            for g in grid_pinpoints)
    max_imgs = max_images_per_batch or batch_size * max_patches

    if packing:
        # sample packing: segment-id rows (TPU throughput headroom the
        # reference leaves on the table, SURVEY.md §5.7). batch_size here
        # = samples gathered per packed batch; rows = batch_size // 2
        # (≈2x density at the reference's ~50%-padding lengths).
        rows = max(batch_size // 2, 1)

        def collate(buf):
            return pack_samples(buf, max_length=max_length, max_rows=rows,
                                max_images=max_imgs, image_size=img_size,
                                dataset_name=dataset_name)
    else:
        def collate(buf):
            return collate_static(buf, max_length=max_length,
                                  max_images=max_imgs, image_size=img_size,
                                  pad_token_id=tokenizer.pad_token_id,
                                  dataset_name=dataset_name)

    return streams.BatchingStream(stream, collate, batch_size)
