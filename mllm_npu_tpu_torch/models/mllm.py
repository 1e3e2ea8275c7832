"""LLaVA-style comprehension assembly (twin of the
``GeneralizedMultimodalModel`` of ``mllm_npu_tpu/models/mllm.py``):
vision encoder → projector → projected image tokens scattered into the
token embeddings at ``ids_cmp_mask`` → LLM. The reference's static-shape
gathers become their eager equivalents; the data contract (images,
embeds_cmp_mask, ids_cmp_mask, patch_positions) is unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mllm_npu_tpu_torch.models.language_models.llama import (
    causal_lm_loss, packed_positions)
from mllm_npu_tpu_torch.ops import SegmentIds


def _safe_unit(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x / ||x||, with a gradient that stays finite at x = 0 (padded image
    slots are exact zeros)."""
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps * eps)


def cosine_loss(rec: torch.Tensor, target: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1 − cosine similarity, meaned over [N, nq]; ``weights`` [N] mask
    padded image slots."""
    per = 1.0 - (_safe_unit(target) * _safe_unit(rec)).sum(-1)
    if weights is None:
        return per.mean()
    w = weights[:, None].to(per.dtype)
    return (per * w).sum() / torch.clamp(w.sum() * per.shape[1], min=1.0)


def mse_loss(rec: torch.Tensor, target: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    per = (rec - target) ** 2   # [N, nq, D]
    if weights is None:
        return per.mean()
    w = weights[:, None, None].to(per.dtype)
    return (per * w).sum() / torch.clamp(
        w.sum() * per.shape[1] * per.shape[2], min=1.0)


def gather_masked_tokens(hidden: torch.Tensor,    # [B, S, D]
                         ids_mask: torch.Tensor,  # [B, S] bool
                         capacity: int) -> torch.Tensor:
    """``hidden[ids_mask]`` in row-major order in ``capacity`` rows [C, D]:
    the masked tokens first (those past the capacity dropped), then
    zeros."""
    picked = hidden[ids_mask][:capacity]
    pad = hidden.new_zeros((capacity - picked.shape[0], hidden.shape[-1]))
    return torch.cat([picked, pad])


def compact_selected(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Rows with ``sel`` True moved to the front in order; the rest zero."""
    out = torch.zeros_like(x)
    picked = x[sel]
    out[:picked.shape[0]] = picked
    return out


def scatter_image_embeds(input_embeds: torch.Tensor,   # [B, S, D]
                         ids_mask: torch.Tensor,        # [B, S] bool
                         image_embeds: torch.Tensor,    # [N, nq, D]
                         ) -> torch.Tensor:
    """``input_embeds[ids_mask] = image_embeds.reshape(-1, D)`` in row-major
    order; slots past the last image row repeat it, as the reference's
    clipped gather does."""
    D = input_embeds.shape[-1]
    flat = image_embeds.reshape(-1, D).to(input_embeds.dtype)
    m = ids_mask.reshape(-1).long()
    slot = (torch.cumsum(m, 0) - m).clamp(0, flat.shape[0] - 1)
    gathered = flat[slot].reshape(input_embeds.shape)
    return torch.where(ids_mask[..., None], gathered, input_embeds)


def _patch_pos_bias(patch_positions: torch.Tensor,
                    table: torch.Tensor) -> torch.Tensor:
    """[N, 2] normalized tile centers × [4, D] corner table → [N, 1, D]."""
    rel = torch.cat([patch_positions, 1 - patch_positions], dim=-1) / 2
    return (rel.to(table.dtype) @ table)[:, None, :]


class GeneralizedMultimodalModel(nn.Module):
    def __init__(self, language_model, vision_encoder, projector, *,
                 add_patch_pos: bool = False, patch_pos_dim: int = 4096,
                 freeze_vision_encoder: bool = True,
                 lm_loss_scale: float = 1.0, ce_loss_chunk: int = 0):
        super().__init__()
        self.language_model = language_model
        self.vision_encoder = vision_encoder
        self.projector = projector
        self.add_patch_pos = add_patch_pos
        self.freeze_vision_encoder = freeze_vision_encoder
        self.lm_loss_scale = lm_loss_scale
        # > 0: the chunked (fused-linear) CE over this many positions
        self.ce_loss_chunk = ce_loss_chunk
        if add_patch_pos:
            self.patch_pos_embed = nn.Parameter(torch.empty(4, patch_pos_dim))

    def forward_images(self, images):
        if self.freeze_vision_encoder:
            with torch.no_grad():
                return self.vision_encoder(images)
        return self.vision_encoder(images)

    def project_images(self, image_embeds, patch_positions=None):
        out = self.projector(image_embeds)
        if self.add_patch_pos and patch_positions is not None:
            out = out + _patch_pos_bias(patch_positions,
                                        self.patch_pos_embed.to(out.dtype))
        return out

    def embed_and_scatter(self, input_ids, images, embeds_cmp_mask,
                          ids_cmp_mask, patch_positions):
        """Token embeddings with the selected images' projected tokens in
        place; returns (input_embeds, encoder tokens or None)."""
        input_embeds = self.language_model.embed(input_ids)
        if images is None:
            return input_embeds, None
        image_embeds = self.forward_images(images)
        proj_in = compact_selected(image_embeds, embeds_cmp_mask)
        pp = None
        if patch_positions is not None:
            pp = compact_selected(patch_positions, embeds_cmp_mask)
        image_embeds_lm = self.project_images(proj_in, pp)
        return (scatter_image_embeds(input_embeds, ids_cmp_mask,
                                     image_embeds_lm), image_embeds)

    def _lm_loss(self, last_hidden, labels):
        """Dense CE over the head's logits, or the chunked fused-linear CE
        from the hidden states when ``ce_loss_chunk`` is set."""
        lm = self.language_model
        if self.ce_loss_chunk:
            return lm.loss_from_hidden(last_hidden, labels,
                                       chunk=self.ce_loss_chunk)
        return causal_lm_loss(lm.logits(last_hidden), labels)

    def compute_losses(self, last_hidden, labels, image_embeds=None,
                       embeds_gen_mask=None, ids_gen_mask=None):
        lm_loss = self._lm_loss(last_hidden, labels)
        return {"total_loss": self.lm_loss_scale * lm_loss,
                "lm_loss": lm_loss}

    def forward(self, input_ids, images, attention_mask, labels,
                embeds_gen_mask=None, embeds_cmp_mask=None,
                ids_gen_mask=None, ids_cmp_mask=None, patch_positions=None):
        input_embeds, image_embeds = self.embed_and_scatter(
            input_ids, images, embeds_cmp_mask, ids_cmp_mask,
            patch_positions)
        seg = positions = segment_ids = None
        if attention_mask is not None:
            seg = attention_mask.to(torch.int32)
            positions = packed_positions(seg)
            segment_ids = SegmentIds(q=seg, kv=seg)
        h, _ = self.language_model(inputs_embeds=input_embeds,
                                   positions=positions,
                                   segment_ids=segment_ids)
        return self.compute_losses(h, labels, image_embeds, embeds_gen_mask,
                                   ids_gen_mask)


class SEED(GeneralizedMultimodalModel):
    """Comprehension and generation: the comprehension assembly plus an
    ``output_projector`` (LLM hidden states at the image-generation tokens
    → the encoder's token space) and its reconstruction loss: the hidden
    states at ``ids_gen_mask`` (``num_img_out_tokens`` per image), through
    the output projector, against the generation images' encoder tokens
    (with ``vit_down`` averaged over groups of 4), MSE (``mse``) or cosine,
    over the image slots that hold a generation target."""

    def __init__(self, language_model, vision_encoder, projector,
                 output_projector, *, rec_loss_scale: float = 1.0,
                 vit_down: bool = False, mse: bool = False,
                 num_img_out_tokens: int = 64, **kw):
        super().__init__(language_model, vision_encoder, projector, **kw)
        self.output_projector = output_projector
        self.rec_loss_scale = rec_loss_scale
        self.vit_down = vit_down
        self.mse = mse
        self.num_img_out_tokens = num_img_out_tokens

    def compute_losses(self, last_hidden, labels, image_embeds=None,
                       embeds_gen_mask=None, ids_gen_mask=None):
        lm_loss = self._lm_loss(last_hidden, labels)
        rec_loss = last_hidden.new_zeros((), dtype=torch.float32)
        if image_embeds is not None and ids_gen_mask is not None:
            N, nq = image_embeds.shape[0], self.num_img_out_tokens
            B, S = ids_gen_mask.shape
            if N * nq > B * S:
                raise ValueError(
                    f"gen-token capacity {N}x{nq} exceeds the sequence "
                    f"budget {B}x{S}; lower max images or raise max_length")
            targets = compact_selected(image_embeds, embeds_gen_mask)
            if self.vit_down:
                n, L, C = targets.shape
                targets = targets.reshape(n, L // 4, 4, C).mean(dim=2)
            n_gen = embeds_gen_mask.sum()
            weights = (torch.arange(N, device=n_gen.device)
                       < n_gen).float()
            out_tokens = gather_masked_tokens(
                last_hidden, ids_gen_mask, N * nq).reshape(
                    N, nq, last_hidden.shape[-1])
            recon = self.output_projector(out_tokens).float()
            targets = targets.detach().float()
            rec_loss = (mse_loss if self.mse else cosine_loss)(
                recon, targets, weights)
        total = self.lm_loss_scale * lm_loss + self.rec_loss_scale * rec_loss
        return {"total_loss": total, "lm_loss": lm_loss,
                "rec_loss": rec_loss}
