"""Tiny builders for CPU-runnable tests (twin of
``mllm_npu_tpu/utils/testing.py:28-65``: the same tiny configs, so a
reference parameter tree loads into the port's model by name)."""

from __future__ import annotations

import dataclasses

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
                    seed: int = 0, llama_kw=None):
    """→ (model, lm_config, vision_config), weights from ``seed`` in
    ``spec.dtype`` on ``device``."""
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
        add_patch_pos=True, device=device, param_dtype=dt, seed=seed)
    return model, lm_cfg, vis_cfg
