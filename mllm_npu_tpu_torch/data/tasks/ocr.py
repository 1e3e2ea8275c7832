"""OCR / conversation task: jsonl ``{image, data: [turn, ...]}`` with
alternating masked-prompt and supervised-answer turns (the port's copy of
``mllm_npu_tpu/data/tasks/ocr.py``: ``decode_llava_data_caption``,
``build_ocr_datapipes_caption`` :155; reference data/tasks/ocr.py:18-269).

The first turn is replaced by the image's tokens (one ``<img>`` span, or
with ``multi_resolution`` a ``<patch>`` span per anyres tile before the
global view's ``<img>`` span) and ``caption_prompt``; later prompt turns
keep their text. Answers are supervised. Every image is a comprehension
input, never a generation target. Lines are read in a per-file
permutation derived from the seed, so the stream's position
(``{"file_idx", "pos"}``) resumes exactly.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
from PIL import Image

from mllm_npu_tpu_torch.constant import (BOI_TOKEN, BOP_TOKEN, EOI_TOKEN,
                                         EOP_TOKEN, IGNORE_INDEX,
                                         image_tokens_str)
from mllm_npu_tpu_torch.data import streams
from mllm_npu_tpu_torch.data.utils import (
    collate_static, grid_pinpoints_from_resolution_grids,
    process_anyres_image)

log = logging.getLogger(__name__)


def _image_tokens(n_patches: int, num_img_in_tokens: int,
                  multi_resolution: bool) -> str:
    """A ``<patch>`` span per tile, then the global view's ``<img>``."""
    if not multi_resolution:
        return image_tokens_str(num_img_in_tokens)
    return "".join(image_tokens_str(num_img_in_tokens, BOP_TOKEN, EOP_TOKEN)
                   for _ in range(n_patches - 1)) \
        + image_tokens_str(num_img_in_tokens)


def decode_llava_data_caption(record: dict, image_dir: str, tokenizer,
                              image_transform=None, caption_prompt="",
                              max_length=128, num_img_in_tokens=64,
                              num_img_out_tokens=64, multi_resolution=False,
                              grid_pinpoints=None, base_resolution=224
                              ) -> dict:
    """One jsonl record → a sample dict (``{}`` where the record is
    dropped: no turns, an unreadable image, a token past the vocabulary, or
    an image span cut by ``max_length``)."""
    if record.get("data") is None:
        return {}

    image = patch_pos = images_patch_length = image_size = None
    embeds_gen_mask = embeds_cmp_mask = None
    if "image" in record:
        path = os.path.join(image_dir, record["image"])
        try:
            img = Image.open(path).convert("RGB")
            if multi_resolution:
                img_size = img.size
                image, patch_pos = process_anyres_image(
                    img, image_transform, grid_pinpoints, base_resolution)
                images_patch_length = np.asarray([len(patch_pos)])
                image_size = np.asarray([img_size])
                embeds_gen_mask = [False] * len(patch_pos)
                embeds_cmp_mask = [True] * len(patch_pos)
            else:
                image = image_transform(img)
                embeds_gen_mask, embeds_cmp_mask = False, True
        except Exception as e:  # noqa: BLE001
            log.warning("bad image skipped: %s", e)
            return {}

    input_ids, labels = [], []
    input_text = ""
    for idx, content in enumerate(record["data"]):
        if idx % 2 == 0:
            if idx == 0:
                text = caption_prompt
                if image is not None:
                    n = (int(images_patch_length[0]) if multi_resolution
                         else 1)
                    text = _image_tokens(n, num_img_in_tokens,
                                         multi_resolution) + caption_prompt
            else:
                text = content
            item_ids = tokenizer.encode(text, add_special_tokens=False)
            item_labels = [IGNORE_INDEX] * len(item_ids)
        else:
            text = content
            item_ids = tokenizer.encode(text, add_special_tokens=False)
            item_labels = item_ids
            if any(x >= tokenizer.vocab_size for x in item_ids):
                return {}
        input_text += text
        input_ids.extend(item_ids)
        labels.extend(item_labels)

    input_ids = ([tokenizer.bos_token_id] + input_ids
                 + [tokenizer.eos_token_id])
    attention_mask = [1] * len(input_ids)
    labels = [IGNORE_INDEX] + labels + [tokenizer.eos_token_id]

    boi = tokenizer.encode(BOI_TOKEN, add_special_tokens=False)[0]
    eoi = tokenizer.encode(EOI_TOKEN, add_special_tokens=False)[0]
    if image is not None and (eoi not in input_ids
                              or input_ids.index(eoi) >= max_length):
        return {}

    n = len(input_ids)
    if n >= max_length:
        input_ids = input_ids[:max_length]
        attention_mask = attention_mask[:max_length]
        labels = labels[:max_length]
    else:
        pad = max_length - n
        input_ids += [tokenizer.pad_token_id] * pad
        attention_mask += [0] * pad
        labels += [IGNORE_INDEX] * pad

    input_ids = np.asarray(input_ids, np.int32)
    ids_cmp_mask = np.zeros(max_length, bool)
    if image is not None:
        boi_idx = int(np.where(input_ids == boi)[0][0])
        eoi_idx = int(np.where(input_ids == eoi)[0][0])
        ids_cmp_mask[boi_idx + 1:eoi_idx] = True
        if multi_resolution:
            bop = tokenizer.encode(BOP_TOKEN, add_special_tokens=False)[0]
            eop = tokenizer.encode(EOP_TOKEN, add_special_tokens=False)[0]
            for b, e in zip(np.where(input_ids == bop)[0],
                            np.where(input_ids == eop)[0]):
                ids_cmp_mask[b + 1:e] = True

    ret = {
        "input_ids": input_ids,
        "attention_mask": np.asarray(attention_mask, np.int32),
        "labels": np.asarray(labels, np.int32),
        "ids_gen_mask": np.zeros(max_length, bool),
        "ids_cmp_mask": ids_cmp_mask,
        "embeds_gen_mask": (np.asarray(embeds_gen_mask)
                            if embeds_gen_mask is not None else None),
        "embeds_cmp_mask": (np.asarray(embeds_cmp_mask)
                            if embeds_cmp_mask is not None else None),
        "images": image,
        "text": input_text,
    }
    if multi_resolution and image is not None:
        ret.update({"images_patch_length": images_patch_length,
                    "patch_position": patch_pos,
                    "image_size": image_size})
    return ret


def build_ocr_datapipes_caption(data_dir, image_dir=None, tokenizer=None,
                                image_transform=None, caption_prompt="",
                                max_length=512, batch_size=None,
                                num_img_in_tokens=64, num_img_out_tokens=64,
                                cycle_count=None, multi_resolution=False,
                                resolution_grids=None, base_resolution=224,
                                dataset_name=None, max_images_per_batch=None,
                                seed=888, shard_for_host=True, **kw):
    """The task's resumable stream over ``data_dir``'s ``*.jsonl`` (images
    under ``image_dir``); with ``batch_size``, static collated batches
    (``collate_static``: up to ``batch_size`` × the most tiles a grid
    gives, plus the global view, images a batch unless
    ``max_images_per_batch``)."""
    grid_pinpoints = []
    if multi_resolution:
        grid_pinpoints = grid_pinpoints_from_resolution_grids(
            list(resolution_grids), base_resolution)

    def list_files():
        files = streams.list_files(data_dir, "*.jsonl")
        return streams.shard_for_host(files) if shard_for_host else files

    def records(path, fi):
        return streams.permuted_lines(path, seed, fi)

    def decode(line, rng):
        s = decode_llava_data_caption(
            json.loads(line), image_dir, tokenizer,
            image_transform=image_transform, caption_prompt=caption_prompt,
            max_length=max_length, num_img_in_tokens=num_img_in_tokens,
            num_img_out_tokens=num_img_out_tokens,
            multi_resolution=multi_resolution,
            grid_pinpoints=grid_pinpoints, base_resolution=base_resolution)
        return s if "input_ids" in s else None

    stream = streams.SampleStream(list_files, records, decode, seed=seed,
                                  cycle_count=cycle_count)
    if batch_size is None:
        return stream

    img_size = getattr(image_transform, "image_size", base_resolution)
    max_patches = 1
    if multi_resolution and grid_pinpoints:
        max_patches = 1 + max(
            (g[0] // base_resolution) * (g[1] // base_resolution)
            for g in grid_pinpoints)
    max_imgs = max_images_per_batch or batch_size * max_patches

    def collate(buf):
        return collate_static(buf, max_length=max_length,
                              max_images=max_imgs, image_size=img_size,
                              pad_token_id=tokenizer.pad_token_id,
                              dataset_name=dataset_name)

    return streams.BatchingStream(stream, collate, batch_size)
