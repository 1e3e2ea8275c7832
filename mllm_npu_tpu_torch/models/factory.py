"""Builders targeted by the port's YAML configs (twins of
``mllm_npu_tpu/models/factory.py`` :123, :137, :149, :231, :245, :264,
:291, :318, and the de-tokenizer's :410 ``build_sdxl_adapter``).

Component builders return a :class:`ModelSpec` (config plus constructor)
and build nothing; :func:`build_mllm` and :func:`build_seed` build the
assembly once, on the ``meta`` device, then allocate it on the target
device in the parameter dtype and fill it from a seeded generator on that
device. So a full-width build never runs 8B or 13B parameters through a
CPU initializer.

Weights are drawn from the seed: loading the reference's checkpoints is
not ported yet, and a configured checkpoint path that exists raises rather
than being silently replaced. A path that does not exist (the repository
ships none) means seeded weights. ``DEBUG_FLAG=True`` swaps every
component for its tiny config, as in the reference, and at full width the
Llama builders default to ``remat=True, remat_policy="dots"``
(reference ``factory.py:130-131``).

``build_mllm(train=True)`` is the training build: the parameters that
train (everything but the vision tower when it is frozen, and every LoRA
base) are held in fp32 and require a gradient; the frozen ones are held
in their component's compute dtype (bf16 at full width) and do not. The
reference keeps every parameter in fp32 but casts frozen ones to the
compute dtype before each product, so the results are the same, and at
8B the port holds about 14 GiB less.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any, Callable, Optional

import torch
from torch import nn

from mllm_npu_tpu_torch.models.language_models.llama import (
    LlamaConfig, LlamaForCausalLM, LoRALinear, RMSNorm)
from mllm_npu_tpu_torch.models.mllm import SEED, GeneralizedMultimodalModel
from mllm_npu_tpu_torch.models.multimodal_encoder.qwenvl_vit import (
    QwenViTConfig, VisionTransformerWithAttnPool)
from mllm_npu_tpu_torch.models.multimodal_encoder.siglip_vit import (
    SigLIPConfig, SigLIPVisionEncoder)
from mllm_npu_tpu_torch.models.multimodal_projector.attention_resampler \
    import AttentionResampler
from mllm_npu_tpu_torch.utils.device import resolve_device

def _debug() -> bool:
    return os.environ.get("DEBUG_FLAG", "False") == "True"


def _no_checkpoint(path) -> None:
    if path and not _debug() and Path(str(path)).exists():
        raise NotImplementedError(
            f"checkpoint {path!r} exists, but loading reference checkpoints "
            "into the port is not implemented yet")


@dataclasses.dataclass
class ModelSpec:
    """A component to build: its config, compute dtype and a constructor
    (no arguments, but a resampler's takes the width of its input under
    ``DEBUG_FLAG``: :func:`build_attention_resampler`)."""
    config: Any
    dtype: torch.dtype
    make: Callable[..., nn.Module]


def _llama_spec(cfg: LlamaConfig, dtype) -> ModelSpec:
    return ModelSpec(cfg, dtype, lambda: LlamaForCausalLM(cfg, dtype=dtype))


def build_llama3(pretrained_model_name_or_path=None, vocab_size=None,
                 dtype=torch.bfloat16, **kw) -> ModelSpec:
    _no_checkpoint(pretrained_model_name_or_path)
    if _debug():
        cfg = LlamaConfig.tiny(vocab_size=vocab_size or 1024, **kw)
    else:
        kw.setdefault("remat", True)
        kw.setdefault("remat_policy", "dots")
        cfg = LlamaConfig.llama3_8b(**kw)
        if vocab_size is not None:
            cfg = dataclasses.replace(cfg, vocab_size=vocab_size)
    return _llama_spec(cfg, dtype)


def build_llama2(pretrained_model_name_or_path=None, vocab_size=None,
                 dtype=torch.bfloat16, **kw) -> ModelSpec:
    _no_checkpoint(pretrained_model_name_or_path)
    if _debug():
        cfg = LlamaConfig.tiny(vocab_size=vocab_size or 1024, **kw)
    else:
        kw.setdefault("remat", True)
        kw.setdefault("remat_policy", "dots")
        cfg = LlamaConfig.llama2_13b(**kw)
        if vocab_size is not None:
            cfg = dataclasses.replace(cfg, vocab_size=vocab_size)
    return _llama_spec(cfg, dtype)


def get_peft_model_with_resize_embedding(model: ModelSpec = None,
                                         peft_config=None, vocab_size=None,
                                         **kw) -> ModelSpec:
    """LoRA on the configured targets, with the adapters' dropout, and the
    vocabulary resized."""
    cfg = model.config
    r, alpha, targets, dropout = 32, 32.0, cfg.lora_targets, 0.0
    if isinstance(peft_config, dict):
        r = peft_config.get("r", r)
        alpha = float(peft_config.get("lora_alpha", alpha))
        targets = tuple(peft_config.get("target_modules", targets))
        dropout = float(peft_config.get("lora_dropout", dropout))
    cfg = dataclasses.replace(cfg, lora_rank=r, lora_alpha=alpha,
                              lora_targets=targets, lora_dropout=dropout,
                              vocab_size=vocab_size or cfg.vocab_size)
    return _llama_spec(cfg, model.dtype)


def build_siglip(pretrained_model_name_or_path=None, hidden_dim=1152,
                 output_dim=4096, dtype=torch.bfloat16, **kw) -> ModelSpec:
    _no_checkpoint(pretrained_model_name_or_path)
    cfg = SigLIPConfig.tiny() if _debug() else SigLIPConfig.so400m_384()
    return ModelSpec(cfg, dtype,
                     lambda: SigLIPVisionEncoder(cfg, dtype=dtype))


def build_qwen_vit(pretrained_model_name_or_path=None, heads=16,
                   image_size=448, layers=48, mlp_ratio=4.9231,
                   output_dim=4096, patch_size=14, width=1664,
                   patch_pos=False, dtype=torch.bfloat16, **kw) -> ModelSpec:
    """Qwen-ViT with its attention pool (ViT-G at the defaults)."""
    _no_checkpoint(pretrained_model_name_or_path)
    cfg = (QwenViTConfig.tiny() if _debug() else
           QwenViTConfig(image_size=image_size, patch_size=patch_size,
                         width=width, layers=layers, heads=heads,
                         mlp_ratio=mlp_ratio, output_dim=output_dim,
                         patch_pos=patch_pos))
    return ModelSpec(cfg, dtype,
                     lambda: VisionTransformerWithAttnPool(cfg, dtype=dtype))


def build_attention_resampler(grid_size: int, embed_dim: int,
                              num_heads: int, kv_dim: Optional[int] = None,
                              dtype=torch.bfloat16, **kw) -> ModelSpec:
    """The resampler; its config holds ``num_queries``, ``embed_dim`` and
    ``num_heads``.
    Under ``DEBUG_FLAG`` it is tiny (4 queries, width 128, 4 heads) and,
    where it has an input projection, takes the tiny producer's width,
    which the assembly builder passes to ``make`` (the reference's Dense
    infers it from the input)."""
    if _debug():
        grid_size, embed_dim, num_heads = 2, 128, 4

    def make(kv_in: Optional[int] = None):
        kv = kv_dim if kv_in is None or kv_dim is None else kv_in
        return AttentionResampler(grid_size=grid_size, embed_dim=embed_dim,
                                  num_heads=num_heads, kv_dim=kv, dtype=dtype)
    return ModelSpec({"num_queries": grid_size ** 2, "embed_dim": embed_dim,
                      "num_heads": num_heads}, dtype, make)


def _width(spec: ModelSpec) -> int:
    """The width of a vision tower's or a Llama's output tokens."""
    return getattr(spec.config, "output_dim", None) or spec.config.hidden_size


def _make_resampler(spec: ModelSpec, producer: ModelSpec) -> nn.Module:
    return spec.make(_width(producer)) if _debug() else spec.make()


def init_random_(module: nn.Module, seed: int = 0, std: float = 0.02
                 ) -> nn.Module:
    """Fill every parameter from one seeded generator on its device:
    normal(0, std) for weights (LoRA B included, so adapters compute),
    zeros for biases, ones for norm scales (RMS, layer and group
    norms)."""
    dev = next(module.parameters()).device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=g)
        for m in module.modules():
            if isinstance(m, (RMSNorm, nn.LayerNorm, nn.GroupNorm)):
                m.weight.fill_(1.0)
    return module


def frozen_parameter_names(model: nn.Module,
                           freeze_vision_encoder: bool = True) -> set:
    """The parameters a training run holds fixed: every LoRA base (the
    reference's ``lora_frozen_patterns``, ``llama.py:210``) and, when it is
    frozen, the whole vision tower (``train.py:224-236``)."""
    names = {f"{n}.weight" for n, m in model.named_modules()
             if isinstance(m, LoRALinear)}
    if freeze_vision_encoder:
        names |= {n for n, _ in model.named_parameters()
                  if n.startswith("vision_encoder.")}
    return names


def materialize(make: Callable[[], nn.Module], *, device=None,
                param_dtype=torch.bfloat16, seed: int = 0,
                frozen: Optional[Callable[[nn.Module], set]] = None
                ) -> nn.Module:
    """Build on ``meta``, allocate on ``device`` (``cuda`` unless named)
    in ``param_dtype``, and fill from ``seed``. With ``frozen`` (the model
    → the names it holds fixed), those parameters stay in ``param_dtype``
    and need no gradient, and every other one is held in fp32."""
    device = resolve_device(device)
    with torch.device("meta"):
        module = make()
    module = module.to(param_dtype)
    if frozen is not None:
        names = frozen(module)
        for name, p in module.named_parameters():
            if name in names:
                p.requires_grad_(False)
            else:
                p.data = p.data.float()
    module = module.to_empty(device=device)
    return init_random_(module, seed)


def build_mllm(language_model: ModelSpec = None,
               vision_encoder: ModelSpec = None,
               projector: ModelSpec = None, freeze_vision_encoder=True,
               lm_loss_scale=1.0, add_patch_pos=False,
               pretrained_model_name_or_path=None,
               pretrained_model_path=None, *, device=None,
               param_dtype=torch.bfloat16, seed: int = 0,
               train: bool = False, ce_loss_chunk: int = 0,
               **kw) -> GeneralizedMultimodalModel:
    """The comprehension assembly with seeded weights on ``device``; with
    ``train`` the training build (fp32 trainable parameters, frozen ones
    in ``param_dtype`` without gradients)."""
    _no_checkpoint(pretrained_model_name_or_path or pretrained_model_path)

    def make():
        return GeneralizedMultimodalModel(
            language_model.make(), vision_encoder.make(),
            _make_resampler(projector, vision_encoder),
            add_patch_pos=add_patch_pos,
            patch_pos_dim=language_model.config.hidden_size,
            freeze_vision_encoder=freeze_vision_encoder,
            lm_loss_scale=lm_loss_scale, ce_loss_chunk=ce_loss_chunk)
    return _materialize_assembly(make, freeze_vision_encoder, device=device,
                                 param_dtype=param_dtype, seed=seed,
                                 train=train)


def build_seed(language_model: ModelSpec = None,
               vision_encoder: ModelSpec = None,
               projector: ModelSpec = None,
               output_projector: ModelSpec = None,
               freeze_vision_encoder=True, lm_loss_scale=1.0,
               rec_loss_scale=1.0, add_patch_pos=False, vit_down=False,
               mse=False, num_img_out_tokens: Optional[int] = None,
               pretrained_model_name_or_path=None,
               pretrained_model_path=None, *, device=None,
               param_dtype=torch.bfloat16, seed: int = 0,
               train: bool = False, ce_loss_chunk: int = 0,
               **kw) -> SEED:
    """The SEED assembly (the comprehension assembly plus its output
    projector and reconstruction loss) with seeded weights on ``device``,
    as :func:`build_mllm`. ``num_img_out_tokens`` defaults to 64 (the
    tiny projector's query count under ``DEBUG_FLAG``); the patch
    positions take the Llama's width."""
    _no_checkpoint(pretrained_model_name_or_path or pretrained_model_path)
    if num_img_out_tokens is None:
        num_img_out_tokens = (projector.config["num_queries"] if _debug()
                              else 64)

    def make():
        return SEED(
            language_model.make(), vision_encoder.make(),
            _make_resampler(projector, vision_encoder),
            _make_resampler(output_projector, language_model),
            rec_loss_scale=rec_loss_scale, vit_down=vit_down, mse=mse,
            num_img_out_tokens=num_img_out_tokens,
            add_patch_pos=add_patch_pos,
            patch_pos_dim=language_model.config.hidden_size,
            freeze_vision_encoder=freeze_vision_encoder,
            lm_loss_scale=lm_loss_scale, ce_loss_chunk=ce_loss_chunk)
    return _materialize_assembly(make, freeze_vision_encoder, device=device,
                                 param_dtype=param_dtype, seed=seed,
                                 train=train)


def _materialize_assembly(make, freeze_vision_encoder, *, device,
                          param_dtype, seed, train):
    frozen = None
    if train:
        def frozen(model):
            return frozen_parameter_names(model, freeze_vision_encoder)
    return materialize(make, device=device, param_dtype=param_dtype,
                       seed=seed, frozen=frozen)


def build_sdxl_adapter(resampler: Optional[dict] = None,
                       unet_checkpoint: Optional[str] = None,
                       vae_checkpoint: Optional[str] = None,
                       adapter_checkpoint: Optional[str] = None,
                       vit_down: bool = False,
                       with_latent_image: bool = False,
                       visual_encoder: Optional[nn.Module] = None,
                       scheduler=None, *, device=None,
                       param_dtype=torch.bfloat16, seed: int = 0):
    """The SDXL de-tokenizer (twin of the reference's
    ``build_sdxl_adapter``, ``factory.py:410-506``): the SDXL-base UNet,
    the SDXL VAE and the resampler (``resampler``: its keywords, a node of
    the generation config; a ``_target_`` picks the class, ResamplerXL by
    default), seeded weights on ``device`` (``cuda`` unless named) stored
    and computed in ``param_dtype``, an Euler scheduler unless another is
    given, and ``visual_encoder`` (the SEED model's vision encoder) for the
    zero-image negative. Under ``DEBUG_FLAG`` everything is the tiny
    configs (the resampler's input width the tiny vision encoder's, as
    the tiny SEED output projector's). A configured checkpoint path that
    exists raises (loading is queue 1 item 16); the 8-channel edit UNet
    (``with_latent_image``) is queue 1 item 14b."""
    from mllm_npu_tpu_torch.configs import resolve_target
    from mllm_npu_tpu_torch.models.generation.adapter_modules import (
        SDXLAdapter)
    from mllm_npu_tpu_torch.models.generation.resampler import ResamplerXL
    from mllm_npu_tpu_torch.models.generation.schedulers import (
        EulerDiscreteScheduler)
    from mllm_npu_tpu_torch.models.generation.unet import (
        UNet2DConditionModel, UNetConfig)
    from mllm_npu_tpu_torch.models.generation.vae import (AutoencoderKL,
                                                          VAEConfig)

    if with_latent_image:
        raise NotImplementedError(
            "SDXLAdapterWithLatentImage (the 8-channel edit UNet) is not "
            "ported yet (ROADMAP queue 1 item 14b)")
    for path in (unet_checkpoint, vae_checkpoint, adapter_checkpoint):
        _no_checkpoint(path)
    resampler = dict(resampler or {})
    cls = resolve_target(resampler.pop("_target_")) \
        if "_target_" in resampler else ResamplerXL
    if _debug():
        ucfg, vcfg = UNetConfig.tiny(), VAEConfig.tiny()
        # the features' width: the tiny vision encoder's (the negative)
        # and the tiny output projector's are both 128
        width = (visual_encoder.config.output_dim if visual_encoder
                 is not None else 128)
        rkw = dict(dim=32, depth=1, dim_head=8, heads=4, num_queries=4,
                   embedding_dim=width, output1_dim=32, output2_dim=32)
    else:
        ucfg, vcfg = UNetConfig.sdxl_base(), VAEConfig.sdxl()
        rkw = dict(dim=1024, depth=4, dim_head=64, heads=16, num_queries=64,
                   embedding_dim=4096, output1_dim=768, output2_dim=1280)
        rkw.update({k: v for k, v in resampler.items()
                    if not k.startswith("_")})
    dt = param_dtype
    mk = lambda make, s: materialize(make, device=device, param_dtype=dt,
                                     seed=s)
    adapter = SDXLAdapter(
        unet=mk(lambda: UNet2DConditionModel(ucfg, dtype=dt), seed),
        resampler=mk(lambda: cls(**rkw, dtype=dt), seed + 1),
        vit_down=vit_down)
    adapter.init_pipe(mk(lambda: AutoencoderKL(vcfg, dtype=dt), seed + 2),
                      scheduler or EulerDiscreteScheduler(),
                      visual_encoder=visual_encoder)
    return adapter
