"""Builders targeted by the port's YAML configs (twins of
``mllm_npu_tpu/models/factory.py`` :123, :137, :149, :231, :245, :264,
:291, :318, and the de-tokenizer's :410 ``build_sdxl_adapter``).

Component builders return a :class:`ModelSpec` (config, constructor and
the checkpoint its YAML names) and build nothing; :func:`build_mllm` and
:func:`build_seed` build the assembly once, on the ``meta`` device, then
allocate it on the target device in the parameter dtype and fill each
parameter from its checkpoint, straight from the mapped file to the
device, or, where no checkpoint supplies it, from a seeded generator on
that device. So a full-width model is never held twice, and never runs
through a CPU initializer.

Checkpoint paths resolve as in the reference (:func:`_maybe`): a null path
means seeded weights; a configured path that does not exist raises
outside ``DEBUG_FLAG`` (a hub id ``org/name`` is tried through
``huggingface_hub`` first); under ``DEBUG_FLAG=True`` every path resolves
to None and every component is its tiny config. The files are read in the
reference's layouts (``utils/weights.py``: HF Llama and SigLIP
directories, ``qwen_vit_G.pt``, the peft-wrapped assembly
``pytorch_model.bin``, diffusers UNet and VAE directories, the
de-tokenizer's checkpoint) and the reference's rules: the vocabulary
resized by the mean rule, a loaded base's LoRA B zero and A drawn as the
reference draws it, an assembly's entries over the components', and an
assembly entry whose shape does not match skipped with a warning (each
model's ``checkpoint_report`` counts them). Anything else a checkpoint
lacks, or holds beyond the model, raises. ``params_checkpoint`` (a
directory of the converter, ``utils/convert.py``) fills the whole model
from one file set instead. At full width the Llama builders default to
``remat=True, remat_policy="dots"`` (reference ``factory.py:130-131``).

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
import functools
import os
import re
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

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
from mllm_npu_tpu_torch.utils import weights as W
from mllm_npu_tpu_torch.utils.checkpoint_files import (converted_state,
                                                       load_hf_dir_or_file)
from mllm_npu_tpu_torch.utils.device import resolve_device


def _debug() -> bool:
    return os.environ.get("DEBUG_FLAG", "False") == "True"


def _maybe(path) -> Optional[str]:
    """A configured checkpoint path, resolved as the reference resolves it
    (``factory.py:49-77``): None for a null path and, under
    ``DEBUG_FLAG``, for every path (tiny seeded models); an existing path
    as it is; a hub id (``org/name``) through ``huggingface_hub``'s
    ``snapshot_download``, imported only then; otherwise
    ``FileNotFoundError``, never seeded weights in its place."""
    if not path or _debug():
        return None
    if Path(str(path)).exists():
        return str(path)
    if re.fullmatch(r"[\w.\-]+/[\w.\-]+", str(path)):
        try:
            from huggingface_hub import snapshot_download
            return snapshot_download(str(path))
        except Exception as e:  # noqa: BLE001
            raise FileNotFoundError(
                f"checkpoint {path!r} is not a local path and hub download "
                f"failed ({type(e).__name__}: {e}): put it under pretrained/ "
                "or fix the path (DEBUG_FLAG=True for checkpoint-free tiny "
                "models)") from e
    raise FileNotFoundError(
        f"configured checkpoint path does not exist: {path!r} (set "
        "DEBUG_FLAG=True for checkpoint-free tiny models, or null the path "
        "for seeded weights)")


@dataclasses.dataclass
class ModelSpec:
    """A component to build: its config, compute dtype and a constructor
    (no arguments, but a resampler's takes the width of its input under
    ``DEBUG_FLAG``: :func:`build_attention_resampler`), and the resolved
    checkpoint its YAML names with the rule (``utils/weights.py``) that
    turns that file's state into the module's."""
    config: Any
    dtype: torch.dtype
    make: Callable[..., nn.Module]
    checkpoint: Optional[str] = None
    convert: Optional[Callable[[dict, Any], dict]] = None

    def state(self) -> Optional[dict]:
        """The module's state from its checkpoint (tensors that view the
        mapped files, and :class:`~utils.weights.Lazy` values), or None."""
        if self.checkpoint is None:
            return None
        return self.convert(load_hf_dir_or_file(self.checkpoint), self.config)


def _llama_spec(cfg: LlamaConfig, dtype, checkpoint=None) -> ModelSpec:
    return ModelSpec(cfg, dtype, lambda: LlamaForCausalLM(cfg, dtype=dtype),
                     checkpoint, functools.partial(W.llama_state, lora="base"))


def build_llama3(pretrained_model_name_or_path=None, vocab_size=None,
                 dtype=torch.bfloat16, **kw) -> ModelSpec:
    """Llama-3-8B from an HF directory or file (converted at ``vocab_size``
    where given, by the mean rule)."""
    ckpt = _maybe(pretrained_model_name_or_path)
    if _debug():
        cfg = LlamaConfig.tiny(vocab_size=vocab_size or 1024, **kw)
    else:
        kw.setdefault("remat", True)
        kw.setdefault("remat_policy", "dots")
        cfg = LlamaConfig.llama3_8b(**kw)
        if vocab_size is not None:
            cfg = dataclasses.replace(cfg, vocab_size=vocab_size)
    return _llama_spec(cfg, dtype, ckpt)


def build_llama2(pretrained_model_name_or_path=None, vocab_size=None,
                 dtype=torch.bfloat16, **kw) -> ModelSpec:
    """Llama-2-13B, as :func:`build_llama3`."""
    ckpt = _maybe(pretrained_model_name_or_path)
    if _debug():
        cfg = LlamaConfig.tiny(vocab_size=vocab_size or 1024, **kw)
    else:
        kw.setdefault("remat", True)
        kw.setdefault("remat_policy", "dots")
        cfg = LlamaConfig.llama2_13b(**kw)
        if vocab_size is not None:
            cfg = dataclasses.replace(cfg, vocab_size=vocab_size)
    return _llama_spec(cfg, dtype, ckpt)


def get_peft_model_with_resize_embedding(model: ModelSpec = None,
                                         peft_config=None, vocab_size=None,
                                         **kw) -> ModelSpec:
    """LoRA on the configured targets, with the adapters' dropout, and the
    vocabulary resized. A base loaded from its checkpoint is resized by the
    mean rule, which the reference intends (``peft_models.py:56-99``) but
    skips on this path (ROADMAP, known issues of the reference), and gets
    fresh adapters: B zero, A by the reference's ``RandomState(0)`` draw."""
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
    return _llama_spec(cfg, model.dtype, model.checkpoint)


def build_siglip(pretrained_model_name_or_path=None, hidden_dim=1152,
                 output_dim=4096, dtype=torch.bfloat16, **kw) -> ModelSpec:
    """SigLIP-so400m-384 from an HF directory or file."""
    ckpt = _maybe(pretrained_model_name_or_path)
    cfg = SigLIPConfig.tiny() if _debug() else SigLIPConfig.so400m_384()
    return ModelSpec(cfg, dtype,
                     lambda: SigLIPVisionEncoder(cfg, dtype=dtype), ckpt,
                     W.siglip_state)


def build_qwen_vit(pretrained_model_name_or_path=None, heads=16,
                   image_size=448, layers=48, mlp_ratio=4.9231,
                   output_dim=4096, patch_size=14, width=1664,
                   patch_pos=False, dtype=torch.bfloat16, **kw) -> ModelSpec:
    """Qwen-ViT with its attention pool (ViT-G at the defaults), from a
    ``qwen_vit_G.pt``-style file (``utils/weights.py reload_qwen_vit`` cuts
    one out of a whole Qwen-VL checkpoint)."""
    ckpt = _maybe(pretrained_model_name_or_path)
    cfg = (QwenViTConfig.tiny() if _debug() else
           QwenViTConfig(image_size=image_size, patch_size=patch_size,
                         width=width, layers=layers, heads=heads,
                         mlp_ratio=mlp_ratio, output_dim=output_dim,
                         patch_pos=patch_pos))
    return ModelSpec(cfg, dtype,
                     lambda: VisionTransformerWithAttnPool(cfg, dtype=dtype),
                     ckpt, W.qwen_vit_state)


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


def init_random_(module: nn.Module, seed: int = 0, std: float = 0.02,
                 skip=frozenset()) -> nn.Module:
    """Fill every parameter from one seeded generator on its device:
    normal(0, std) for weights (LoRA B included, so adapters compute),
    zeros for biases, ones for norm scales (RMS, layer and group norms).
    The parameters named in ``skip`` (those a checkpoint fills) draw
    nothing."""
    dev = next(module.parameters()).device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name in skip:
                continue
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


@torch.no_grad()
def load_state_(module: nn.Module, state: Dict[str, Any],
                group: Optional[str] = None) -> Dict[str, dict]:
    """Copy each entry of ``state`` (a tensor, or a ``Lazy`` made here)
    into the parameter of that name, one at a time, onto its device and
    into its dtype; a name the module does not hold, or a shape that
    differs, raises. → per component (the name's first part, or ``group``)
    the tensors, bytes and seconds (the device synchronised at each
    component's end)."""
    params = dict(module.named_parameters())
    unexpected = sorted(set(state) - set(params))
    if unexpected:
        raise KeyError(f"{len(unexpected)} checkpoint entries are not "
                       f"parameters of the model, e.g. {unexpected[:3]}")
    order: Dict[str, list] = {}
    for name in state:
        order.setdefault(group or name.split(".")[0], []).append(name)
    report = {}
    for part, names in order.items():
        t0, nbytes = time.perf_counter(), 0
        for name in names:
            src = state[name]
            src = src() if isinstance(src, W.Lazy) else src
            dst = params[name]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: checkpoint shape "
                                 f"{tuple(src.shape)}, model "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
            nbytes += src.numel() * src.element_size()
        dev = next(iter(params.values())).device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        report[part] = {"tensors": len(names), "bytes": nbytes,
                        "seconds": time.perf_counter() - t0}
    return report


def _on_meta(make: Callable[[], nn.Module], param_dtype,
             frozen: Optional[Callable[[nn.Module], set]] = None
             ) -> nn.Module:
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
    return module


def _shapes(module: nn.Module) -> Dict[str, torch.Size]:
    return {n: p.shape for n, p in module.named_parameters()}


def _fill(module: nn.Module, device, seed: int, state: Dict[str, Any],
          group: Optional[str] = None, skipped=()) -> nn.Module:
    """Allocate the meta ``module`` on ``device``, draw what ``state`` does
    not hold from ``seed`` and copy ``state`` in; the model's
    ``checkpoint_report`` holds :func:`load_state_`'s report, the skipped
    entries and the seeded parameters' count."""
    module = module.to_empty(device=device)
    init_random_(module, seed, skip=set(state))
    report = load_state_(module, state, group) if state else {}
    module.checkpoint_report = {
        "loaded": report, "skipped": list(skipped),
        "seeded": sum(1 for n, _ in module.named_parameters()
                      if n not in state)}
    return module


def _require(state: Dict[str, Any], shapes: Dict[str, torch.Size],
             prefix: str, source) -> None:
    """Every parameter under ``prefix`` must be in ``state``."""
    missing = sorted(n for n in shapes
                     if n.startswith(prefix) and n not in state)
    if missing:
        raise KeyError(f"{source}: {len(missing)} parameters missing, e.g. "
                       f"{missing[:3]}")


def materialize(make: Callable[[], nn.Module], *, device=None,
                param_dtype=torch.bfloat16, seed: int = 0,
                frozen: Optional[Callable[[nn.Module], set]] = None
                ) -> nn.Module:
    """Build on ``meta``, allocate on ``device`` (``cuda`` unless named)
    in ``param_dtype``, and fill from ``seed``. With ``frozen`` (the model
    → the names it holds fixed), those parameters stay in ``param_dtype``
    and need no gradient, and every other one is held in fp32."""
    device = resolve_device(device)
    return _fill(_on_meta(make, param_dtype, frozen), device, seed, {})


def build_component(spec: ModelSpec, *, device=None,
                    param_dtype=torch.bfloat16, seed: int = 0) -> nn.Module:
    """One component alone (a Llama, a vision tower) from its spec: its
    checkpoint's state, every parameter required, the rest (a loaded base's
    fresh adapters) by the rules, nothing from ``seed`` unless it has no
    checkpoint."""
    device = resolve_device(device)
    module = _on_meta(spec.make, param_dtype)
    state = spec.state() or {}
    if spec.checkpoint is not None:
        _require(state, _shapes(module), "", spec.checkpoint)
    return _fill(module, device, seed, state)


def build_mllm(language_model: ModelSpec = None,
               vision_encoder: ModelSpec = None,
               projector: ModelSpec = None, freeze_vision_encoder=True,
               lm_loss_scale=1.0, add_patch_pos=False,
               pretrained_model_name_or_path=None,
               pretrained_model_path=None, *, device=None,
               param_dtype=torch.bfloat16, seed: int = 0,
               train: bool = False, ce_loss_chunk: int = 0,
               params_checkpoint: Optional[str] = None,
               **kw) -> GeneralizedMultimodalModel:
    """The comprehension assembly on ``device``, from the components'
    checkpoints, then the assembly's (``pretrained_model_name_or_path`` or
    ``pretrained_model_path``), the rest drawn from ``seed``; or wholly
    from ``params_checkpoint`` (the converter's directory). With
    ``train`` the training build (fp32 trainable parameters, frozen ones
    in ``param_dtype`` without gradients)."""
    assembly = _maybe(pretrained_model_name_or_path or pretrained_model_path)

    def make():
        return GeneralizedMultimodalModel(
            language_model.make(), vision_encoder.make(),
            _make_resampler(projector, vision_encoder),
            add_patch_pos=add_patch_pos,
            patch_pos_dim=language_model.config.hidden_size,
            freeze_vision_encoder=freeze_vision_encoder,
            lm_loss_scale=lm_loss_scale, ce_loss_chunk=ce_loss_chunk)
    parts = {"language_model": language_model,
             "vision_encoder": vision_encoder, "projector": projector}
    return _materialize_assembly(
        make, parts, assembly, freeze_vision_encoder, device=device,
        param_dtype=param_dtype, seed=seed, train=train,
        params_checkpoint=params_checkpoint)


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
               params_checkpoint: Optional[str] = None,
               **kw) -> SEED:
    """The SEED assembly (the comprehension assembly plus its output
    projector and reconstruction loss) on ``device``, loaded and seeded as
    :func:`build_mllm`. ``num_img_out_tokens`` defaults to 64 (the tiny
    projector's query count under ``DEBUG_FLAG``); the patch positions
    take the Llama's width."""
    assembly = _maybe(pretrained_model_name_or_path or pretrained_model_path)
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
    parts = {"language_model": language_model,
             "vision_encoder": vision_encoder, "projector": projector,
             "output_projector": output_projector}
    return _materialize_assembly(
        make, parts, assembly, freeze_vision_encoder, device=device,
        param_dtype=param_dtype, seed=seed, train=train,
        params_checkpoint=params_checkpoint)


def _materialize_assembly(make, parts: Dict[str, ModelSpec], assembly,
                          freeze_vision_encoder, *, device, param_dtype,
                          seed, train, params_checkpoint=None):
    """Build the assembly on ``meta``, gather its state (the converter's
    directory alone, or each component's checkpoint, every parameter of a
    loaded component required, then the assembly checkpoint's entries over
    them, those whose shape differs from the model's skipped with a
    warning) and fill it on ``device``."""
    device = resolve_device(device)
    frozen = None
    if train:
        def frozen(model):
            return frozen_parameter_names(model, freeze_vision_encoder)
    module = _on_meta(make, param_dtype, frozen)
    shapes = _shapes(module)
    state: Dict[str, Any] = {}
    skipped = []
    if params_checkpoint:
        state = converted_state(params_checkpoint)
        _require(state, shapes, "", params_checkpoint)
    else:
        for name, spec in parts.items():
            part = spec.state()
            if part is None:
                continue
            state.update({f"{name}.{k}": v for k, v in part.items()})
            _require(state, shapes, f"{name}.", spec.checkpoint)
        if assembly:
            vis = parts["vision_encoder"]
            asm = W.assembly_state(load_hf_dir_or_file(assembly),
                                   parts["language_model"].config,
                                   vis.convert, vis.config)
            unexpected = sorted(set(asm) - set(shapes))
            if unexpected:
                raise KeyError(f"{assembly}: {len(unexpected)} entries are "
                               "not parameters of the model, e.g. "
                               f"{unexpected[:3]}")
            skipped = W.remove_mismatched_weights(shapes, asm)
            state.update(asm)
    return _fill(module, device, seed, state, skipped=skipped)


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
    zero-image negative. The UNet and the VAE load from diffusers
    directories, and the de-tokenizer's checkpoint (``split_adapter_state``)
    gives the resampler and either a whole UNet or a tuned subset (the
    ``to_k`` / ``to_v`` keys SEED-X trains) merged key by key over the UNet,
    strictly: an unknown key or a shape that differs raises. Under
    ``DEBUG_FLAG`` everything is the tiny configs (the resampler's input
    width the tiny vision encoder's, as the tiny SEED output projector's)
    and nothing loads. ``with_latent_image`` builds SEED-X-Edit's
    ``SDXLAdapterWithLatentImage`` over the 8-channel UNet (a diffusers
    directory's ``conv_in`` then has 8 input channels); under
    ``DEBUG_FLAG`` its tiny UNet takes 8 channels too, where the
    reference's stays at 4, which its edit path cannot run."""
    from mllm_npu_tpu_torch.configs import resolve_target
    from mllm_npu_tpu_torch.models.generation.adapter_modules import (
        SDXLAdapter, SDXLAdapterWithLatentImage)
    from mllm_npu_tpu_torch.models.generation.resampler import ResamplerXL
    from mllm_npu_tpu_torch.models.generation.schedulers import (
        EulerDiscreteScheduler)
    from mllm_npu_tpu_torch.models.generation.unet import (
        UNet2DConditionModel, UNetConfig)
    from mllm_npu_tpu_torch.models.generation.vae import (AutoencoderKL,
                                                          VAEConfig)

    unet_ckpt, vae_ckpt, adapter_ckpt = (
        _maybe(p) for p in (unet_checkpoint, vae_checkpoint,
                            adapter_checkpoint))
    resampler = dict(resampler or {})
    cls = resolve_target(resampler.pop("_target_")) \
        if "_target_" in resampler else ResamplerXL
    in_channels = 8 if with_latent_image else 4
    if _debug():
        ucfg = UNetConfig.tiny(in_channels=in_channels)
        vcfg = VAEConfig.tiny()
        # the features' width: the tiny vision encoder's (the negative)
        # and the tiny output projector's are both 128
        width = (visual_encoder.config.output_dim if visual_encoder
                 is not None else 128)
        rkw = dict(dim=32, depth=1, dim_head=8, heads=4, num_queries=4,
                   embedding_dim=width, output1_dim=32, output2_dim=32)
    else:
        ucfg = UNetConfig.sdxl_base(in_channels=in_channels)
        vcfg = VAEConfig.sdxl()
        rkw = dict(dim=1024, depth=4, dim_head=64, heads=16, num_queries=64,
                   embedding_dim=4096, output1_dim=768, output2_dim=1280)
        rkw.update({k: v for k, v in resampler.items()
                    if not k.startswith("_")})
    device = resolve_device(device)
    full = {"unet": load_hf_dir_or_file(unet_ckpt) if unet_ckpt else None,
            "vae": W.vae_state(load_hf_dir_or_file(vae_ckpt))
            if vae_ckpt else None, "resampler": None}
    partial_unet = {}
    if adapter_ckpt:
        res_sd, unet_sd = W.split_adapter_state(
            load_hf_dir_or_file(adapter_ckpt))
        if res_sd:
            full["resampler"] = res_sd
        if "conv_in.weight" in unet_sd:     # a whole UNet
            full["unet"] = unet_sd
        else:                               # the tuned subset
            partial_unet = unet_sd

    def part(name, make, s):
        module = _on_meta(make, param_dtype)
        shapes = _shapes(module)
        state = dict(full[name] or {})
        if full[name] is not None:
            _require(state, shapes, "", f"{name} checkpoint")
        if name == "unet" and partial_unet:
            W.merge_partial_state(state, partial_unet, shapes,
                                  f"{adapter_ckpt} (unet.*)")
        return _fill(module, device, s, state, group=name)

    dt = param_dtype
    adapter_cls = SDXLAdapterWithLatentImage if with_latent_image \
        else SDXLAdapter
    adapter = adapter_cls(
        unet=part("unet", lambda: UNet2DConditionModel(ucfg, dtype=dt), seed),
        resampler=part("resampler", lambda: cls(**rkw, dtype=dt), seed + 1),
        vit_down=vit_down)
    adapter.init_pipe(part("vae", lambda: AutoencoderKL(vcfg, dtype=dt),
                           seed + 2),
                      scheduler or EulerDiscreteScheduler(),
                      visual_encoder=visual_encoder)
    return adapter
