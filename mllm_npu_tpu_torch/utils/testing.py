"""Tiny builders for CPU-runnable tests (twin of
``mllm_npu_tpu/utils/testing.py:28-65``: the same tiny configs, so a
reference parameter tree loads into the port's model by name)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mllm_npu_tpu_torch.models.factory import (ModelSpec, build_mllm)
from mllm_npu_tpu_torch.models.language_models.llama import (
    LlamaConfig, LlamaForCausalLM)
from mllm_npu_tpu_torch.models.multimodal_encoder.siglip_vit import (
    SigLIPConfig, SigLIPVisionEncoder)
from mllm_npu_tpu_torch.models.multimodal_projector.attention_resampler \
    import AttentionResampler


@dataclasses.dataclass
class TinySpec:
    image_size: int = 56
    nq: int = 4           # image tokens per image
    vocab: int = 4096     # matches FakeTokenizer's id range
    dtype: torch.dtype = torch.float32


def build_tiny_mllm(spec: TinySpec = TinySpec(), *, device=None,
                    seed: int = 0, llama_kw=None, **build_kw):
    """→ (model, lm_config, vision_config), weights from ``seed`` in
    ``spec.dtype`` on ``device``; ``build_kw`` goes to ``build_mllm``
    (``train=True``, ``ce_loss_chunk``, …)."""
    lm_cfg = LlamaConfig.tiny(vocab_size=spec.vocab, **(llama_kw or {}))
    vis_cfg = SigLIPConfig.tiny(image_size=spec.image_size)
    dt = spec.dtype
    grid = int(spec.nq ** 0.5)
    model = build_mllm(
        language_model=ModelSpec(lm_cfg, dt,
                                 lambda: LlamaForCausalLM(lm_cfg, dtype=dt)),
        vision_encoder=ModelSpec(vis_cfg, dt,
                                 lambda: SigLIPVisionEncoder(vis_cfg, dt)),
        projector=ModelSpec(None, dt, lambda: AttentionResampler(
            grid_size=grid, embed_dim=lm_cfg.hidden_size, num_heads=4,
            kv_dim=vis_cfg.hidden_size, dtype=dt)),
        add_patch_pos=True, device=device, param_dtype=dt, seed=seed,
        **build_kw)
    return model, lm_cfg, vis_cfg


def synthetic_batch(spec: TinySpec = TinySpec(), *, batch: int = 2,
                    seq: int = 64, max_images: int = 2, cmp_images: int = 1,
                    rng: int = 0) -> dict:
    """A numpy training batch obeying the data contract (twin of
    ``mllm_npu_tpu/utils/testing.py synthetic_batch`` without generation
    targets): ``nq`` True slots of ``ids_cmp_mask`` per selected image, in
    order, with those positions unsupervised."""
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
    return {
        "input_ids": input_ids,
        "images": rs.randn(max_images, spec.image_size, spec.image_size,
                           3).astype(np.float32),
        "attention_mask": np.ones((batch, seq), np.int32),
        "labels": labels,
        "embeds_cmp_mask": embeds_cmp_mask,
        "embeds_gen_mask": np.zeros((max_images,), bool),
        "ids_cmp_mask": ids_cmp_mask,
        "ids_gen_mask": np.zeros((batch, seq), bool),
        "patch_positions": rs.rand(max_images, 2).astype(np.float32),
    }
