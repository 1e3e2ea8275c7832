"""Interleaved image-text task: .pkl records inside tars with
{'images': [b64|None, ...], 'texts': [str|None, ...]} — each image gets
a comprehension/generation coin-flip (``img_first_ratio``), sequences
accumulate until max_length (the port's copy of
``mllm_npu_tpu/data/tasks/interleaved_image_text.py``; reference
data/tasks/interleaved_image_text.py:19-302)."""

from __future__ import annotations

import pickle
import random
from typing import Optional

import numpy as np

from mllm_npu_tpu_torch.constant import (BOP_TOKEN, EOP_TOKEN,
                                         IGNORE_INDEX, image_tokens_str)
from mllm_npu_tpu_torch.data import streams
from mllm_npu_tpu_torch.data.data_utils import base64_to_image
from mllm_npu_tpu_torch.data.utils import (
    collate_static, grid_pinpoints_from_resolution_grids,
    process_anyres_image)


def decode_interleave_data(pkl_bytes: bytes, tokenizer, image_transform=None,
                           max_length=1024, img_first_ratio=1.0,
                           num_img_in_tokens=64, num_img_out_tokens=64,
                           multi_resolution=False, grid_pinpoints=None,
                           base_resolution=224,
                           rng: Optional[random.Random] = None) -> dict:
    rng = rng or random
    try:
        value = pickle.loads(pkl_bytes)
        image_list, text_list = value["images"], value["texts"]
    except Exception:  # noqa: BLE001
        return {}

    images = []
    input_ids = [tokenizer.bos_token_id]
    labels = [IGNORE_INDEX]
    cur_len = 1
    embeds_cmp_mask, embeds_gen_mask = [], []
    ids_cmp_mask, ids_gen_mask = [False], [False]
    images_patch_length, image_size, patch_position = [], [], []
    input_text = ""

    for image_b64, text in zip(image_list, text_list):
        if (image_b64 is None) == (text is None):
            return {}
        if image_b64 is not None:
            try:
                image = base64_to_image(image_b64)
            except Exception:  # noqa: BLE001
                return {}
            img_first = rng.uniform(0, 1) < img_first_ratio
            if img_first:
                if multi_resolution:
                    img_size = image.size
                    patches, ppos = process_anyres_image(
                        image, image_transform, grid_pinpoints,
                        base_resolution)
                    n = len(ppos)
                    if cur_len + (num_img_in_tokens + 2) * n >= max_length:
                        break
                    patch_position.append(ppos)
                    images_patch_length.append(n)
                    image_size.append(img_size)
                    embeds_cmp_mask.extend([True] * n)
                    embeds_gen_mask.extend([False] * n)
                    image_tokens = "".join(
                        image_tokens_str(num_img_in_tokens, BOP_TOKEN,
                                         EOP_TOKEN)
                        for _ in range(n - 1))
                    image_tokens += image_tokens_str(num_img_in_tokens)
                    image_ids = tokenizer.encode(image_tokens,
                                                 add_special_tokens=False)
                    image_labels = [IGNORE_INDEX] * len(image_ids)
                    for _ in range(n):
                        ids_cmp_mask.extend(
                            [False] + [True] * num_img_in_tokens + [False])
                        ids_gen_mask.extend(
                            [False] * (num_img_in_tokens + 2))
                    images.append(patches)
                else:
                    if cur_len + num_img_in_tokens >= max_length:
                        break
                    embeds_cmp_mask.append(True)
                    embeds_gen_mask.append(False)
                    image_tokens = image_tokens_str(num_img_in_tokens)
                    image_ids = tokenizer.encode(image_tokens,
                                                 add_special_tokens=False)
                    image_labels = [IGNORE_INDEX] * len(image_ids)
                    ids_cmp_mask.extend(
                        [False] + [True] * num_img_in_tokens + [False])
                    ids_gen_mask.extend([False] * (num_img_in_tokens + 2))
                    images.append(image_transform(image)[None])
            else:
                if cur_len + num_img_out_tokens >= max_length:
                    break
                embeds_cmp_mask.append(False)
                embeds_gen_mask.append(True)
                image_tokens = image_tokens_str(num_img_out_tokens)
                image_ids = tokenizer.encode(image_tokens,
                                             add_special_tokens=False)
                image_labels = ([image_ids[0]]
                                + [IGNORE_INDEX] * (len(image_ids) - 1))
                ids_cmp_mask.extend([False] * (num_img_out_tokens + 2))
                ids_gen_mask.extend(
                    [False] + [True] * num_img_out_tokens + [False])
                if multi_resolution:
                    # generation targets are single full-image crops
                    thumb = image.resize((base_resolution, base_resolution))
                    images.append(image_transform(thumb)[None])
                    patch_position.append(
                        np.asarray([[0.5, 0.5]], np.float32))
                    images_patch_length.append(1)
                    image_size.append(image.size)
                else:
                    images.append(image_transform(image)[None])

            input_ids.extend(image_ids)
            labels.extend(image_labels)
            cur_len += len(image_ids)
            input_text += image_tokens
        else:
            text_ids = tokenizer.encode(text, add_special_tokens=False)
            if cur_len + len(text_ids) >= max_length:
                break
            input_ids.extend(text_ids)
            labels.extend(text_ids)
            cur_len += len(text_ids)
            input_text += text

    if not images:
        return {}

    input_ids.append(tokenizer.eos_token_id)
    labels.append(tokenizer.eos_token_id)
    attention_mask = [1] * len(input_ids)
    ids_cmp_mask.append(False)
    ids_gen_mask.append(False)

    pad = max_length - len(input_ids)
    if pad < 0:
        return {}
    input_ids += [tokenizer.pad_token_id] * pad
    attention_mask += [0] * pad
    labels += [IGNORE_INDEX] * pad
    ids_cmp_mask += [False] * pad
    ids_gen_mask += [False] * pad

    ret = {
        "input_ids": np.asarray(input_ids, np.int32),
        "attention_mask": np.asarray(attention_mask, np.int32),
        "labels": np.asarray(labels, np.int32),
        "ids_gen_mask": np.asarray(ids_gen_mask),
        "ids_cmp_mask": np.asarray(ids_cmp_mask),
        "embeds_gen_mask": np.asarray(embeds_gen_mask),
        "embeds_cmp_mask": np.asarray(embeds_cmp_mask),
        "images": np.concatenate(images, axis=0),
        "text": input_text,
    }
    if multi_resolution:
        ret.update({
            "images_patch_length": np.asarray(images_patch_length),
            "patch_position": np.concatenate(patch_position, axis=0),
            "image_size": np.asarray(image_size),
        })
    return ret


def build_interleave_datapipes_with_pixels(
        data_dir, tokenizer=None, image_transform=None, max_length=1024,
        batch_size=None, img_first_ratio=1.0, num_img_in_tokens=64,
        num_img_out_tokens=64, cycle_count=None, multi_resolution=False,
        resolution_grids=None, base_resolution=224, dataset_name=None,
        max_images_per_batch=None, seed=888, shard_for_host=True, **kw):
    grid_pinpoints = []
    if multi_resolution:
        grid_pinpoints = grid_pinpoints_from_resolution_grids(
            list(resolution_grids), base_resolution)

    def list_files():
        files = streams.list_files(data_dir, "*.tar")
        return streams.shard_for_host(files) if shard_for_host else files

    def records(tar_path, _fi):
        return (data for inner, data in streams.iter_tar_members(tar_path)
                if inner.endswith(".pkl"))

    def decode(data, rng):
        s = decode_interleave_data(
            data, tokenizer, image_transform=image_transform,
            max_length=max_length, img_first_ratio=img_first_ratio,
            num_img_in_tokens=num_img_in_tokens,
            num_img_out_tokens=num_img_out_tokens,
            multi_resolution=multi_resolution,
            grid_pinpoints=grid_pinpoints,
            base_resolution=base_resolution, rng=rng)
        return s if "input_ids" in s else None

    stream = streams.SampleStream(list_files, records, decode, seed=seed,
                                  cycle_count=cycle_count)
    if batch_size is None:
        return stream

    # the transform resizes every patch to its own output size
    img_size = getattr(image_transform, "image_size", base_resolution)
    max_patches = 1
    if multi_resolution and grid_pinpoints:
        max_patches = 1 + max(
            (g[0] // base_resolution) * (g[1] // base_resolution)
            for g in grid_pinpoints)
    # interleaved rows can hold several images; budget generously
    max_imgs = max_images_per_batch or batch_size * max_patches * 2

    def collate(buf):
        return collate_static(buf, max_length=max_length,
                              max_images=max_imgs, image_size=img_size,
                              pad_token_id=tokenizer.pad_token_id,
                              dataset_name=dataset_name)

    return streams.BatchingStream(stream, collate, batch_size)
