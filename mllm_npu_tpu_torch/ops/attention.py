"""Plain-tensor attention (twin of ``mllm_npu_tpu/ops/attention.py``).

Layout, as in the reference: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] with
Hq % Hkv == 0 (GQA); segment ids int [B, S] (tokens attend only within
equal ids). Decode attention is plain tensor code in the reference too,
so it has no hand kernel here.
"""

from __future__ import annotations

from typing import Optional

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def make_attention_mask(*, q_len: int, kv_len: int, causal: bool = False,
                        q_segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None,
                        q_offset: int = 0, device=None
                        ) -> Optional[torch.Tensor]:
    """Boolean [B or 1, q_len, kv_len] mask (True = attend), or None."""
    mask = None
    if causal:
        q_idx = torch.arange(q_len, device=device)[:, None]
        kv_idx = torch.arange(kv_len, device=device)[None, :]
        mask = ((q_idx + q_offset) >= kv_idx)[None]
    if q_segment_ids is not None:
        seg = q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]
        mask = seg if mask is None else (mask & seg)
    return mask


def dot_product_attention(q, k, v, *, causal: bool = False,
                          attn_mask: Optional[torch.Tensor] = None,
                          q_segment_ids=None, kv_segment_ids=None,
                          q_offset: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Eager GQA attention with causal, segment and dense masks; softmax in
    fp32. ``attn_mask`` (True = attend) may be [B?, Sk], [B?, H', Sq, Sk]
    with H' in {1, Hkv, Hq}, or a full [B, Hkv, G, Sq, Sk]."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {Hq} % {Hkv}")
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    qf = (q.float() * scale).reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    mask = make_attention_mask(q_len=Sq, kv_len=Sk, causal=causal,
                               q_segment_ids=q_segment_ids,
                               kv_segment_ids=kv_segment_ids,
                               q_offset=q_offset, device=q.device)
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None], DEFAULT_MASK_VALUE)
    if attn_mask is not None:
        if attn_mask.ndim == 2:
            am = attn_mask[:, None, None, None, :]
        elif attn_mask.ndim == 4:
            if attn_mask.shape[1] == Hq and Hq != Hkv:
                am = attn_mask.reshape(attn_mask.shape[0], Hkv, G,
                                       *attn_mask.shape[2:])
            else:
                am = attn_mask[:, :, None]
        else:
            am = attn_mask
        logits = logits.masked_fill(~am, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def decode_attention(q, k, v, attn_mask, *, k_cur=None, v_cur=None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Cached-decode attention over a read-only cache.

    q [B, Sq, Hq, D]; k/v [B, Sk, Hkv, D] in the cache dtype; ``attn_mask``
    broadcastable to [B, 1, 1, Sk] (True = attend). ``k_cur``/``v_cur``
    [B, W, Hkv, D] append the current tokens' keys/values as virtual
    columns (causal within the window), so the caller writes the cache
    once after the layer pass. Products are taken in the compute dtype
    (bf16 for an 8-bit cache) and accumulated in fp32, as the reference's
    ``preferred_element_type=float32``: the operands are widened to fp32
    exactly before each product. ``attn_mask`` may be per row
    ([B, 1, 1, Sk]): the batched engine's decode block writes each step's
    column into its static cache in place and widens the row's mask, so
    the reference's block buffers (``blk_k``/``blk_v``/``blk_mask``, there
    so XLA's scan would not copy the whole cache a step) have no use here.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    comp = torch.bfloat16 if k.element_size() == 1 else k.dtype
    kc = k.to(comp).float()
    vc = v.to(comp).float()
    qg = (q.float() * scale).to(comp).float().reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc)
    am = torch.broadcast_to(attn_mask, (B, 1, 1, Sk)).reshape(B, 1, 1, 1, Sk)
    logits = logits.masked_fill(~am, DEFAULT_MASK_VALUE)
    if k_cur is not None:
        self_logit = torch.einsum("bqhgd,bshd->bhgqs", qg,
                                  k_cur.to(comp).float())
        W = k_cur.shape[1]
        if W > 1 or Sq > 1:
            cm = (torch.arange(Sq, device=q.device)[:, None]
                  >= torch.arange(W, device=q.device)[None, :])
            self_logit = self_logit.masked_fill(~cm, DEFAULT_MASK_VALUE)
        logits = torch.cat([logits, self_logit], dim=-1)
    probs = torch.softmax(logits, dim=-1).to(comp).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs[..., :Sk], vc)
    if k_cur is not None:
        out = out + torch.einsum("bhgqs,bshd->bqhgd", probs[..., Sk:],
                                 v_cur.to(comp).float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)
