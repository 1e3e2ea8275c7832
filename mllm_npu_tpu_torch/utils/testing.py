"""Tiny builders for CPU-runnable tests (twin of
``mllm_npu_tpu/utils/testing.py:28-65``: the same tiny configs, so a
reference parameter tree loads into the port's model by name)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mllm_npu_tpu_torch.models.factory import (ModelSpec, build_mllm,
                                               build_seed)
from mllm_npu_tpu_torch.models.language_models.llama import (
    LlamaConfig, LlamaForCausalLM)
from mllm_npu_tpu_torch.models.multimodal_encoder.qwenvl_vit import (
    QwenViTConfig, VisionTransformerWithAttnPool)
from mllm_npu_tpu_torch.models.multimodal_encoder.siglip_vit import (
    SigLIPConfig, SigLIPVisionEncoder)
from mllm_npu_tpu_torch.models.multimodal_projector.attention_resampler \
    import AttentionResampler
from mllm_npu_tpu_torch.utils.weights import qwen_vit_state, siglip_state


@dataclasses.dataclass
class TinySpec:
    image_size: int = 56
    nq: int = 4           # image tokens per image
    vocab: int = 4096     # matches FakeTokenizer's id range
    dtype: torch.dtype = torch.float32


def build_tiny_mllm(spec: TinySpec = TinySpec(), *, device=None,
                    seed: int = 0, llama_kw=None, seed_x: bool = False,
                    tower: str = "siglip", **build_kw):
    """→ (model, lm_config, vision_config), weights from ``seed`` in
    ``spec.dtype`` on ``device``; ``build_kw`` goes to ``build_mllm`` or
    ``build_seed`` (``train=True``, ``ce_loss_chunk``, …). ``seed_x``
    builds the SEED assembly (the reference's ``seed=True``: an output
    projector back to the tower's width, ``vit_down``, the cosine loss,
    ``nq`` output tokens an image); ``tower`` is ``"siglip"`` (the
    reference's tiny tower) or ``"qwen"`` (``QwenViTConfig.tiny``, the
    SEED-X tower with its attention pool)."""
    lm_cfg = LlamaConfig.tiny(vocab_size=spec.vocab, **(llama_kw or {}))
    dt = spec.dtype
    if tower == "qwen":
        vis_cfg = QwenViTConfig.tiny(image_size=spec.image_size)
        vis_width = vis_cfg.output_dim
        vision = ModelSpec(vis_cfg, dt, lambda: VisionTransformerWithAttnPool(
            vis_cfg, dt), convert=qwen_vit_state)
    else:
        vis_cfg = SigLIPConfig.tiny(image_size=spec.image_size)
        vis_width = vis_cfg.hidden_size
        vision = ModelSpec(vis_cfg, dt,
                           lambda: SigLIPVisionEncoder(vis_cfg, dt),
                           convert=siglip_state)
    grid = int(spec.nq ** 0.5)

    def resampler(embed_dim, kv_dim):
        return ModelSpec(None, dt, lambda kv_in=None: AttentionResampler(
            grid_size=grid, embed_dim=embed_dim, num_heads=4, kv_dim=kv_dim,
            dtype=dt))
    kw = dict(
        language_model=ModelSpec(lm_cfg, dt,
                                 lambda: LlamaForCausalLM(lm_cfg, dtype=dt)),
        vision_encoder=vision,
        projector=resampler(lm_cfg.hidden_size, vis_width),
        add_patch_pos=True, device=device, param_dtype=dt, seed=seed,
        **build_kw)
    if seed_x:
        model = build_seed(
            output_projector=resampler(vis_width, lm_cfg.hidden_size),
            rec_loss_scale=1.0, vit_down=True, mse=False,
            num_img_out_tokens=spec.nq, **kw)
    else:
        model = build_mllm(**kw)
    return model, lm_cfg, vis_cfg


def synthetic_batch(spec: TinySpec = TinySpec(), *, batch: int = 2,
                    seq: int = 64, max_images: int = 2, cmp_images: int = 1,
                    gen_images: int = 0, rng: int = 0) -> dict:
    """A numpy training batch obeying the data contract (twin of
    ``mllm_npu_tpu/utils/testing.py synthetic_batch``): ``nq`` True slots
    of ``ids_cmp_mask`` per selected image, in order, with those positions
    unsupervised; then ``nq`` of ``ids_gen_mask`` per generation target,
    the image slots after the comprehension ones."""
    rs = np.random.RandomState(rng)
    nq = spec.nq
    input_ids = rs.randint(10, spec.vocab, (batch, seq)).astype(np.int32)
    labels = input_ids.copy()
    ids_cmp_mask = np.zeros((batch, seq), bool)
    embeds_cmp_mask = np.zeros((max_images,), bool)
    pos = 4
    for i in range(cmp_images):
        embeds_cmp_mask[i] = True
        row = i % batch
        ids_cmp_mask[row, pos:pos + nq] = True
        labels[row, pos:pos + nq] = -100
        pos += nq + 2
    embeds_gen_mask = np.zeros((max_images,), bool)
    ids_gen_mask = np.zeros((batch, seq), bool)
    for i in range(gen_images):
        embeds_gen_mask[cmp_images + i] = True
        ids_gen_mask[i % batch, pos:pos + nq] = True
        pos += nq + 2
    return {
        "input_ids": input_ids,
        "images": rs.randn(max_images, spec.image_size, spec.image_size,
                           3).astype(np.float32),
        "attention_mask": np.ones((batch, seq), np.int32),
        "labels": labels,
        "embeds_cmp_mask": embeds_cmp_mask,
        "embeds_gen_mask": embeds_gen_mask,
        "ids_cmp_mask": ids_cmp_mask,
        "ids_gen_mask": ids_gen_mask,
        "patch_positions": rs.rand(max_images, 2).astype(np.float32),
    }
