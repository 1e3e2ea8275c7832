"""Any-resolution tiling and static-shape collates (numpy + PIL): the
port's copy of ``mllm_npu_tpu/data/utils.py:30-311``.

Pick the best grid from the resolution candidates with both selectors
(max effective resolution and closest aspect ratio) and keep the smaller;
resize; cut into ``base_image_size`` tiles; append the global thumbnail;
emit normalized tile-center positions with the thumbnail at (0.5, 0.5).
:func:`collate_static` pads a batch to fixed shapes (``max_length``
tokens, ``max_images`` image slots); :func:`pack_samples` packs samples
into rows with per-sample segment ids in ``attention_mask``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
from PIL import Image

from mllm_npu_tpu_torch.constant import IGNORE_INDEX


def select_best_resolution(original_size, possible_resolutions):
    """Max-effective-resolution selector."""
    ow, oh = original_size
    best, best_eff, best_waste = None, 0, float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = w * h - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (w, h), eff, waste
    return best


def select_best_resolution_v2(original_size, possible_resolutions):
    """Aspect-ratio-closest selector."""
    ow, oh = original_size
    oar, oarea = oh / ow, ow * oh
    best, best_ar, best_area = None, float("inf"), float("inf")
    for w, h in possible_resolutions:
        ar, area = h / w, w * h
        ar_diff = max(ar, oar) / min(ar, oar)
        area_ratio = max(area, oarea) / min(area, oarea)
        if ar_diff < best_ar or (ar_diff == best_ar
                                 and area_ratio < best_area):
            best, best_ar, best_area = (w, h), ar_diff, area_ratio
    return best


def divide_to_patches(image: Image.Image, patch_size: int):
    patches = []
    w, h = image.size
    for i in range(0, h, patch_size):
        for j in range(0, w, patch_size):
            patches.append(image.crop((j, i, j + patch_size,
                                       i + patch_size)))
    return patches


def grid_pinpoints_from_resolution_grids(resolution_grids,
                                         base_resolution: int):
    """'2x3' strings → pixel pinpoints."""
    out = []
    for scale in resolution_grids:
        s1, s2 = str(scale).split("x")
        out.append([int(s1) * base_resolution, int(s2) * base_resolution])
    return out


def process_anyres_image(image: Image.Image, image_transform: Callable,
                         grid_pinpoints, base_image_size: int):
    """``grid_pinpoints`` [[w, h], ...] in pixels → (patches [P, H, W, 3]
    float32 NHWC, patch_pos [P, 2]) with P = grid tiles + 1 thumbnail."""
    w1, h1 = select_best_resolution(image.size, grid_pinpoints)
    w2, h2 = select_best_resolution_v2(image.size, grid_pinpoints)
    w, h = (w2, h2) if w1 * h1 > w2 * h2 else (w1, h1)

    # the reference's resize_and_pad_image without keep_ratio: a resize
    patches = divide_to_patches(image.resize((w, h)), base_image_size)
    thumb = image.resize((base_image_size, base_image_size))
    arrays = [image_transform(p) for p in patches + [thumb]]

    gx, gy = w // base_image_size, h // base_image_size
    x_idx = (np.tile(np.arange(gx), (gy, 1)) + 0.5) / gx
    y_idx = (np.tile(np.arange(gy)[:, None], (1, gx)) + 0.5) / gy
    pos = np.stack([x_idx, y_idx], axis=-1).reshape(-1, 2)
    pos = np.concatenate([pos, np.asarray([[0.5, 0.5]])], axis=0)
    return np.stack(arrays).astype(np.float32), pos.astype(np.float32)


# ---------------------------------------------------------------------------
# Static-shape collates
# ---------------------------------------------------------------------------

_SEQ_KEYS = ("input_ids", "attention_mask", "labels", "ids_gen_mask",
             "ids_cmp_mask")
_IMG_AXIS_KEYS = ("images", "embeds_gen_mask", "embeds_cmp_mask",
                  "patch_position")


def _pad_seq(arr: np.ndarray, max_length: int, pad_value) -> np.ndarray:
    if arr.shape[0] >= max_length:
        return arr[:max_length]
    pad = np.full((max_length - arr.shape[0],) + arr.shape[1:], pad_value,
                  arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def collate_static(batch: list[dict], *, max_length: int, max_images: int,
                   image_size: int, pad_token_id: int = 0,
                   dataset_name: Optional[str] = None) -> dict:
    """Fixed-shape batch assembly. Samples arrive with per-sample arrays:
    seq keys [L...], images [P?, H, W, 3] (or [H,W,3], or None),
    embeds_*_mask [P?] (or scalar bool), patch_position [P?, 2].

    Output: seq keys [B, max_length]; images [max_images, H, W, 3];
    embeds masks [max_images]; patch_positions [max_images, 2].
    The reference's row-major contract is preserved: each sample's
    images append in batch order, matching its ids_* True spans.
    """
    B = len(batch)
    pad_map = {"input_ids": pad_token_id, "attention_mask": 0,
               "labels": IGNORE_INDEX, "ids_gen_mask": False,
               "ids_cmp_mask": False}

    out = {}
    for key in _SEQ_KEYS:
        rows = []
        for s in batch:
            arr = np.asarray(s[key])
            rows.append(_pad_seq(arr, max_length, pad_map[key]))
        out[key] = np.stack(rows)

    imgs, cmp_m, gen_m, ppos = [], [], [], []
    for s in batch:
        im = s.get("images")
        if im is None:
            continue
        im = np.asarray(im, np.float32)
        if im.ndim == 3:
            im = im[None]
        n = im.shape[0]
        imgs.append(im)
        cm = np.asarray(s.get("embeds_cmp_mask", False)).reshape(-1)
        gm = np.asarray(s.get("embeds_gen_mask", False)).reshape(-1)
        if cm.shape[0] != n:
            cm = np.repeat(cm[:1], n)
        if gm.shape[0] != n:
            gm = np.repeat(gm[:1], n)
        cmp_m.append(cm)
        gen_m.append(gm)
        pp = s.get("patch_position")
        ppos.append(np.asarray(pp, np.float32) if pp is not None
                    else np.full((n, 2), 0.5, np.float32))

    if imgs:
        images = np.concatenate(imgs, axis=0)
        cmp_mask = np.concatenate(cmp_m).astype(bool)
        gen_mask = np.concatenate(gen_m).astype(bool)
        patch_positions = np.concatenate(ppos, axis=0)
    else:
        images = np.zeros((0, image_size, image_size, 3), np.float32)
        cmp_mask = np.zeros((0,), bool)
        gen_mask = np.zeros((0,), bool)
        patch_positions = np.zeros((0, 2), np.float32)

    n = images.shape[0]
    if n > max_images:
        raise ValueError(
            f"batch has {n} image patches > capacity {max_images}; raise "
            "max_images or lower batch size")
    pad_n = max_images - n
    out["images"] = np.concatenate(
        [images, np.zeros((pad_n, image_size, image_size, 3), np.float32)],
        axis=0)
    out["embeds_cmp_mask"] = np.concatenate([cmp_mask,
                                             np.zeros((pad_n,), bool)])
    out["embeds_gen_mask"] = np.concatenate([gen_mask,
                                             np.zeros((pad_n,), bool)])
    out["patch_positions"] = np.concatenate(
        [patch_positions, np.full((pad_n, 2), 0.5, np.float32)], axis=0)
    out["dataset_name"] = dataset_name
    return out


def pack_samples(samples: list[dict], *, max_length: int,
                 max_rows: int, max_images: int, image_size: int,
                 dataset_name=None) -> dict:
    """Sample packing (TPU headroom the reference leaves on the table,
    SURVEY.md §5.7): concatenate unpadded samples into ``max_rows``
    packed rows. attention_mask carries per-sample segment ids
    (1, 2, ...; 0 = padding) which the models feed to the flash kernel
    as segment_ids and use to restart positions per sample.

    Samples must carry unpadded (or pad-stripped) arrays; each sample's
    images stay aligned with its ids_* spans because packing preserves
    row-major order.
    """
    rows = [[] for _ in range(max_rows)]
    lengths = [0] * max_rows
    for s in samples:
        real = int(np.asarray(s["attention_mask"]).sum())
        # first-fit
        for r in range(max_rows):
            if lengths[r] + real <= max_length:
                rows[r].append({k: (np.asarray(v)[:real]
                                    if k in _SEQ_KEYS else v)
                                for k, v in s.items()})
                lengths[r] += real
                break

    out_seq = {k: np.zeros((max_rows, max_length),
                           np.int32 if k in ("input_ids",
                                             "attention_mask",
                                             "labels") else bool)
               for k in _SEQ_KEYS}
    out_seq["labels"][:] = IGNORE_INDEX
    imgs, cmp_m, gen_m, ppos = [], [], [], []
    for r, row in enumerate(rows):
        off = 0
        for si, s in enumerate(row):
            L = int(np.asarray(s["attention_mask"]).sum())
            sl = slice(off, off + L)
            out_seq["input_ids"][r, sl] = s["input_ids"][:L]
            out_seq["attention_mask"][r, sl] = si + 1   # segment id
            labels = np.asarray(s["labels"][:L]).copy()
            labels[0] = IGNORE_INDEX   # no cross-sample first-token target
            out_seq["labels"][r, sl] = labels
            out_seq["ids_cmp_mask"][r, sl] = s["ids_cmp_mask"][:L]
            out_seq["ids_gen_mask"][r, sl] = s["ids_gen_mask"][:L]
            off += L
            im = s.get("images")
            if im is None:
                continue
            im = np.asarray(im, np.float32)
            if im.ndim == 3:
                im = im[None]
            n = im.shape[0]
            imgs.append(im)
            cm = np.asarray(s.get("embeds_cmp_mask", False)).reshape(-1)
            gm = np.asarray(s.get("embeds_gen_mask", False)).reshape(-1)
            if cm.shape[0] != n:
                cm = np.repeat(cm[:1], n)
            if gm.shape[0] != n:
                gm = np.repeat(gm[:1], n)
            cmp_m.append(cm)
            gen_m.append(gm)
            pp = s.get("patch_position", s.get("patch_positions"))
            ppos.append(np.asarray(pp, np.float32) if pp is not None
                        else np.full((n, 2), 0.5, np.float32))

    if imgs:
        images = np.concatenate(imgs, axis=0)
        cmp_mask = np.concatenate(cmp_m).astype(bool)
        gen_mask = np.concatenate(gen_m).astype(bool)
        patch_positions = np.concatenate(ppos, axis=0)
    else:
        images = np.zeros((0, image_size, image_size, 3), np.float32)
        cmp_mask = np.zeros((0,), bool)
        gen_mask = np.zeros((0,), bool)
        patch_positions = np.zeros((0, 2), np.float32)
    n = images.shape[0]
    if n > max_images:
        raise ValueError(f"{n} image patches > capacity {max_images}")
    pad_n = max_images - n
    return {
        **{k: v for k, v in out_seq.items()},
        "images": np.concatenate(
            [images, np.zeros((pad_n, image_size, image_size, 3),
                              np.float32)], axis=0),
        "embeds_cmp_mask": np.concatenate(
            [cmp_mask, np.zeros((pad_n,), bool)]),
        "embeds_gen_mask": np.concatenate(
            [gen_mask, np.zeros((pad_n,), bool)]),
        "patch_positions": np.concatenate(
            [patch_positions, np.full((pad_n, 2), 0.5, np.float32)],
            axis=0),
        "dataset_name": dataset_name,
    }
