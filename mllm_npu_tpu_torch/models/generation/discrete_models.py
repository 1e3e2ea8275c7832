"""The identity discrete front-end (twin of ``DiscreteModelIdentity``,
``mllm_npu_tpu/models/generation/discrete_models.py:40``), the one the
SEED-X de-tokenizer's config names. The contrastive and VQ models are
ROADMAP queue 1 item 13b."""

from __future__ import annotations

from torch import nn


class DiscreteModelIdentity(nn.Module):
    def forward(self, image_embeds):
        return image_embeds
