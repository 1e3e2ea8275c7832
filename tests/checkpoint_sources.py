"""Checkpoints in the reference's layouts for the port's loading tests,
made at tiny width from sources independent of the port: HF
``transformers`` models (Llama, SigLIP), ``peft`` for the adapter-wrapped
assembly, torch's own modules for the Qwen-ViT tower and the attention
resamplers (the reference's structure, ``qwenvl_vit.py``), and the
diffusers-layout synthesizers of ``test_unet_vae_conversion.py``.

``patch_tiny`` makes the full-width config constructors of both packages
return the tiny configs, so the builders run outside ``DEBUG_FLAG`` (where
checkpoints load) at a size the CPU takes in seconds."""

from __future__ import annotations

import torch
from torch import nn

# the tiny Llama's base vocabulary: under the engine's 4096, so the
# builders' resize by the mean rule runs
BASE_VOCAB = 4000
VOCAB = 4096
LORA = dict(r=8, lora_alpha=16, lora_dropout=0.0,
            target_modules=["q_proj", "v_proj", "k_proj", "o_proj",
                            "gate_proj", "down_proj", "up_proj"])


def patch_tiny(setattr_, jax=True):
    """Point every full-width config constructor at its tiny config
    (``setattr_`` is ``monkeypatch.setattr`` or ``setattr``); with ``jax``
    the reference's too."""
    import mllm_npu_tpu_torch.models.generation.unet as tu
    import mllm_npu_tpu_torch.models.generation.vae as tv
    import mllm_npu_tpu_torch.models.language_models.llama as tl
    import mllm_npu_tpu_torch.models.multimodal_encoder.siglip_vit as ts
    mods = [(tl, ts, tu, tv)]
    if jax:
        import mllm_npu_tpu.models.generation.unet as ju
        import mllm_npu_tpu.models.generation.vae as jv
        import mllm_npu_tpu.models.language_models.llama as jl
        import mllm_npu_tpu.models.multimodal_encoder.siglip_vit as js
        mods.append((jl, js, ju, jv))
    for lm, sig, unet, vae in mods:
        L = lm.LlamaConfig
        tiny = classmethod(lambda cls, **kw: cls.tiny(vocab_size=BASE_VOCAB,
                                                      **kw))
        setattr_(L, "llama3_8b", tiny)
        setattr_(L, "llama2_13b", tiny)
        setattr_(sig.SigLIPConfig, "so400m_384",
                 classmethod(lambda cls, **kw: cls.tiny(**kw)))
        setattr_(unet.UNetConfig, "sdxl_base",
                 classmethod(lambda cls, **kw: cls.tiny(**kw)))
        setattr_(vae.VAEConfig, "sdxl",
                 classmethod(lambda cls, **kw: cls.tiny(**kw)))


def hf_llama(vocab=BASE_VOCAB, seed=0):
    """An HF ``LlamaForCausalLM`` at the tiny Llama's shapes."""
    from transformers import LlamaConfig, LlamaForCausalLM
    torch.manual_seed(seed)
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=vocab, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=2048, rms_norm_eps=1e-5,
        attn_implementation="eager")).eval()


def hf_llama_state(vocab=BASE_VOCAB, seed=0, scale=0.5):
    """Its state dict with every tensor jittered (HF initialises norms to
    ones), so a missed or misplaced tensor shows."""
    g = torch.Generator().manual_seed(seed + 100)
    sd = hf_llama(vocab, seed).state_dict()
    return {k: (v + scale * 0.05 * torch.randn(v.shape, generator=g)).
            contiguous() for k, v in sd.items()}


def trained_adapters(sd, cfg_layers=2, r=LORA["r"], seed=1, prefix="model."):
    """``lora_A`` / ``lora_B`` for every target of an HF Llama state, as a
    trained peft model holds them (B non-zero)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i in range(cfg_layers):
        for mod in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                    "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
                    "mlp.down_proj"):
            w = sd[f"{prefix}layers.{i}.{mod}.weight"]
            key = f"{prefix}layers.{i}.{mod}"
            out[f"{key}.lora_A.weight"] = 0.1 * torch.randn(
                (r, w.shape[1]), generator=g)
            out[f"{key}.lora_B.weight"] = 0.1 * torch.randn(
                (w.shape[0], r), generator=g)
    return out


def hf_siglip_state(seed=0, image_size=56):
    """An HF ``SiglipVisionModel`` at the tiny SigLIP's shapes (its pooling
    head included, which the reference does not read)."""
    from transformers import SiglipVisionConfig, SiglipVisionModel
    torch.manual_seed(seed)
    m = SiglipVisionModel(SiglipVisionConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, image_size=image_size, patch_size=14,
        layer_norm_eps=1e-6, attn_implementation="eager"))
    g = torch.Generator().manual_seed(seed + 100)
    return {k: v + 0.02 * torch.randn(v.shape, generator=g) if
            v.is_floating_point() else v for k, v in m.state_dict().items()}


def resampler_state(embed_dim, kv_dim, grid, heads=4, seed=0):
    """The reference's ``AttentionResampler`` state: ``query``, a bias-free
    ``kv_proj`` (where the input's width differs),
    ``nn.MultiheadAttention`` and two LayerNorms."""
    torch.manual_seed(seed)
    m = nn.Module()
    m.query = nn.Parameter(0.5 * torch.randn(grid * grid, embed_dim))
    if kv_dim is not None and kv_dim != embed_dim:
        m.kv_proj = nn.Linear(kv_dim, embed_dim, bias=False)
    m.attn = nn.MultiheadAttention(embed_dim, heads)
    m.ln_q = nn.LayerNorm(embed_dim)
    m.ln_kv = nn.LayerNorm(embed_dim)
    g = torch.Generator().manual_seed(seed + 100)
    return {k: v.detach() + 0.05 * torch.randn(v.shape, generator=g)
            for k, v in m.state_dict().items()}


def qwen_vit_state(width=64, layers=1, heads=4, mlp=64, patch=14, grid=4,
                   out_dim=128, pool_grid=4, seed=0, mha_blocks=False):
    """A ``qwen_vit_G.pt``-style state at the tiny tower's shapes (the
    reference's ``VisionTransformerWithAttnPool``: a bias-free ``conv1``,
    pre-LN blocks whose attention is a fused ``in_proj`` Linear — or, with
    ``mha_blocks``, ``nn.MultiheadAttention``'s names — the attention pool,
    ``ln_post`` and ``proj``)."""
    torch.manual_seed(seed)
    m = nn.Module()
    m.conv1 = nn.Conv2d(3, width, patch, patch, bias=False)
    m.positional_embedding = nn.Parameter(torch.randn(grid * grid, width)
                                          * width ** -0.5)
    m.ln_pre = nn.LayerNorm(width)
    m.transformer = nn.Module()
    m.transformer.resblocks = nn.ModuleList()
    for _ in range(layers):
        b = nn.Module()
        b.ln_1, b.ln_2 = nn.LayerNorm(width), nn.LayerNorm(width)
        if mha_blocks:
            b.attn = nn.MultiheadAttention(width, heads)
        else:
            b.attn = nn.Module()
            b.attn.in_proj = nn.Linear(width, 3 * width)
            b.attn.out_proj = nn.Linear(width, width)
        b.mlp = nn.Module()
        b.mlp.c_fc = nn.Linear(width, mlp)
        b.mlp.c_proj = nn.Linear(mlp, width)
        m.transformer.resblocks.append(b)
    m.ln_post = nn.LayerNorm(out_dim)
    m.proj = nn.Parameter(out_dim ** -0.5 * torch.randn(out_dim, out_dim))
    g = torch.Generator().manual_seed(seed + 100)
    sd = {k: v.detach() + 0.05 * torch.randn(v.shape, generator=g)
          for k, v in m.state_dict().items()}
    sd.update({f"attn_pool.{k}": v for k, v in resampler_state(
        out_dim, width, pool_grid, heads, seed + 1).items()})
    return sd


def peft_language_model_state(sd, seed=2):
    """The state of ``peft.get_peft_model`` over an HF Llama holding ``sd``
    (the reference's ``LoraConfig`` with ``modules_to_save``,
    ``seedx_llama2_13b_qwenvl_vitg.yaml:39-57``), its adapters trained
    (B non-zero) and its saved modules changed from the originals."""
    from peft import LoraConfig, get_peft_model
    vocab = sd["model.embed_tokens.weight"].shape[0]
    hf = hf_llama(vocab)
    hf.load_state_dict(sd)
    pm = get_peft_model(hf, LoraConfig(
        modules_to_save=["input_layernorm", "post_attention_layernorm",
                         "norm"], **LORA))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in pm.named_parameters():
            if "lora_B" in n or "modules_to_save" in n:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return pm.state_dict()
