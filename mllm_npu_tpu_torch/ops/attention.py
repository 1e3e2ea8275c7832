"""Plain-tensor attention (twin of ``mllm_npu_tpu/ops/attention.py``).

Layout, as in the reference: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] with
Hq % Hkv == 0 (GQA); segment ids int [B, S] (tokens attend only within
equal ids). Decode attention is plain tensor code in the reference too,
so it has no hand kernel here: on the GPU its two products over a bf16
cache are cuBLAS batched GEMMs on the cache as stored (an 8-bit cache is
widened to bf16 first).
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
    once after the layer pass. The compute dtype is the cache's (bf16 for
    an 8-bit cache, which is widened to bf16 first, as the reference
    does); q·Kᵀ gives fp32 logits, the softmax is fp32, and P, rounded to
    the compute dtype, times V accumulates in fp32: the reference's
    ``preferred_element_type=float32``. On the GPU both products over a
    bf16 cache are batched GEMMs on the cache as stored
    (:func:`_cache_bmm`: one per row, strided over its heads, fp32
    output), so a bf16 cache is read once and never copied; an 8-bit
    cache is widened to a bf16 copy of K and V each call, and the
    products run on that copy. On the CPU, and
    for an fp32 cache, the operands are widened to fp32 exactly before
    each product (bf16 × bf16 is exact in fp32; only the summation order
    differs). The current tokens' columns are small and take that form
    everywhere. ``attn_mask`` may be per row
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
    stored = _products_on_stored(k)
    qg = (q.float() * scale).to(comp)
    if stored:
        kc = k if k.dtype == comp else k.to(comp)
        # [B, Hkv, G·Sq, D]: row (g, s) of each KV head's query block
        qh = qg.reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4).reshape(
            B, Hkv, G * Sq, D)
        logits = _cache_bmm(qh, kc.permute(0, 2, 3, 1)).reshape(
            B, Hkv, G, Sq, Sk)
    else:
        kc = k.to(comp).float()
        logits = torch.einsum("bqhgd,bkhd->bhgqk",
                              qg.float().reshape(B, Sq, Hkv, G, D), kc)
    qg = qg.float().reshape(B, Sq, Hkv, G, D)
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
    probs = torch.softmax(logits, dim=-1).to(comp)
    if stored:
        vc = v if v.dtype == comp else v.to(comp)
        # P's cache columns made contiguous: as a slice of [.., Sk + W]
        # their row stride is odd, and cuBLAS then takes a SIMT kernel
        # many times slower than the tensor-core ones
        pc = probs[..., :Sk].contiguous().reshape(B, Hkv, G * Sq, Sk)
        out = _cache_bmm(pc, vc.permute(0, 2, 1, 3))    # [B, Hkv, G·Sq, D]
        out = out.reshape(B, Hkv, G, Sq, D).permute(0, 3, 1, 2, 4)
    else:
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs[..., :Sk].float(),
                           v.to(comp).float())
    if k_cur is not None:
        out = out + torch.einsum("bhgqs,bshd->bqhgd", probs[..., Sk:].float(),
                                 v_cur.to(comp).float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def _products_on_stored(k: torch.Tensor) -> bool:
    """Whether :func:`decode_attention` takes its products over the cache
    as stored (:func:`_cache_bmm`): on the GPU for a bf16 or 8-bit cache.
    An fp32 cache needs no widening and keeps the einsums, which on the
    H100 beat fp32 products over the strided views (``PERF.md`` §5, the
    f32 cache's step). (The CPU's ``bmm`` has no ``out_dtype``; the CPU
    tests run the strided path in fp32 by patching this.)"""
    return k.is_cuda and k.dtype != torch.float32


def _cache_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, H, M, K] @ [B, H, K, N] → fp32 [B, H, M, N] on the GPU, ``b`` a
    strided view of the cache. One batched GEMM per row b over its H heads:
    within a row the heads sit at one stride, so cuBLAS reads the cache in
    place, where a single product over (B, H) would need the two strides
    folded into one and so a copy of the whole cache. bf16 operands give
    fp32 output (``out_dtype``): products exact, sums in fp32. (fp32
    operands: the CPU tests' run of this path.)"""
    B, H, M, _ = a.shape
    out = torch.empty((B, H, M, b.shape[-1]), dtype=torch.float32,
                      device=a.device)
    for i in range(B):
        if a.dtype == torch.float32:
            torch.bmm(a[i], b[i], out=out[i])
        else:
            torch.bmm(a[i], b[i], out_dtype=torch.float32, out=out[i])
    return out
