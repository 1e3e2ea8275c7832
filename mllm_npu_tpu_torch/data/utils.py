"""Any-resolution tiling (numpy + PIL): the port's copy of
``mllm_npu_tpu/data/utils.py:30-120``.

Pick the best grid from the resolution candidates with both selectors
(max effective resolution and closest aspect ratio) and keep the smaller;
resize; cut into ``base_image_size`` tiles; append the global thumbnail;
emit normalized tile-center positions with the thumbnail at (0.5, 0.5).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
from PIL import Image


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
