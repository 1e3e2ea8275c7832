"""Sample-level helpers: the similarity filter, unwrap and select (the
port's copy of the parts of ``mllm_npu_tpu/data/data_utils.py`` that the
caption task uses)."""

from __future__ import annotations

import json


def filter_data_with_similarity(item: dict, similarity_thr: float = 0.2,
                                assure_text: bool = True) -> bool:
    """CLIP-similarity filter from wds metadata (reference
    data_utils.py:87-115)."""
    if "images" not in item:
        return False
    if not item.get("filter_flag", True):
        return False
    if assure_text and "text" not in item:
        return False
    try:
        metadata = json.loads(item.get("metadata", "{}"))
    except Exception:  # noqa: BLE001
        return False
    sim = None
    if "all_similarities" in metadata:
        sim = max(metadata["all_similarities"])
    elif "similarity" in metadata:
        sim = metadata["similarity"]
    elif "score" in metadata:
        sim = metadata["score"]
    elif "SCORE" in metadata:
        sim = metadata["SCORE"]
    if sim is not None and sim < similarity_thr:
        return False
    return True


def unwarp_data(item: dict) -> dict:
    out = {}
    for key, value in item.items():
        if isinstance(value, dict):
            out.update(value)
        elif value is not None:
            out[key] = value
    if "metadata" not in out:
        out["metadata"] = "{}"
    return out


def select(sample: dict) -> dict:
    ret = {k: sample[k] for k in (
        "input_ids", "attention_mask", "labels", "ids_gen_mask",
        "ids_cmp_mask", "embeds_gen_mask", "embeds_cmp_mask", "images")}
    for k in ("images_patch_length", "patch_position", "image_size"):
        if k in sample:
            ret[k] = sample[k]
    return ret
