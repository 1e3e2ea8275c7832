"""Pure-text LM task: jsonl {'text': ...} → padded samples (the port's
copy of ``mllm_npu_tpu/data/tasks/pure_text.py``; reference
data/tasks/pure_text.py:11-92)."""

from __future__ import annotations

import json

import numpy as np

from mllm_npu_tpu_torch.constant import IGNORE_INDEX
from mllm_npu_tpu_torch.data import streams
from mllm_npu_tpu_torch.data.utils import collate_static


def decode_text_pretrain(record: dict, tokenizer, max_length=512) -> dict:
    text = record.get("text")
    if text is None or text.strip(" ;,[]{}'\".?:") == "":
        return {}
    ids = ([tokenizer.bos_token_id]
           + tokenizer.encode(text, add_special_tokens=False)
           + [tokenizer.eos_token_id])
    ids = ids[:max_length]
    attn = [1] * len(ids)
    pad = max_length - len(ids)
    input_ids = np.asarray(ids + [tokenizer.pad_token_id] * pad, np.int32)
    attention_mask = np.asarray(attn + [0] * pad, np.int32)
    labels = input_ids.copy()
    labels[attention_mask == 0] = IGNORE_INDEX
    zeros = np.zeros((max_length,), bool)
    return {
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "labels": labels.astype(np.int32),
        "ids_gen_mask": zeros,
        "ids_cmp_mask": zeros.copy(),
        "embeds_gen_mask": None,
        "embeds_cmp_mask": None,
        "images": None,
        "text": text,
    }


def build_text_datapipes(data_dir, tokenizer=None, image_transform=None,
                         max_length=512, batch_size=None, cycle_count=None,
                         dataset_name=None, image_size=448, seed=888,
                         max_images_per_batch=1, shard_for_host=True, **kw):
    def list_files():
        files = streams.list_files(data_dir, "*.jsonl")
        return streams.shard_for_host(files) if shard_for_host else files

    def records(path, fi):
        return streams.permuted_lines(path, seed, fi)

    def decode(line, rng):
        rec = json.loads(line)
        s = decode_text_pretrain(rec, tokenizer, max_length)
        return s if "input_ids" in s else None

    stream = streams.SampleStream(list_files, records, decode, seed=seed,
                                  cycle_count=cycle_count)
    if batch_size is None:
        return stream

    # sample order randomized by the per-file line permutation
    # (index-derived, checkpointable) — no streaming shuffle buffer
    def collate(buf):
        return collate_static(buf, max_length=max_length,
                              max_images=max_images_per_batch,
                              image_size=image_size,
                              pad_token_id=tokenizer.pad_token_id,
                              dataset_name=dataset_name)

    return streams.BatchingStream(stream, collate, batch_size)


# reference alias (pure_text.py builder name)
build_text_pretrain_datapipes_for_llm = build_text_datapipes
