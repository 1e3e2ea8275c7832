"""The de-tokenizers: image features → image (twin of
``mllm_npu_tpu/models/generation/adapter_modules.py``: ``SDXLAdapter``, its
edit, LoRA and SD-2.1 variants, the IP-Adapter and its pipe, the trainable
sets, ``compute_time_ids``, ``_postprocess_u8`` and ``_to_pil``).

``SDXLAdapter.generate`` takes the LLM's image features (SEED's output
projector, [B, 64, 4096] at full width), stacks them with the classifier-
free-guidance negative, the vision encoder's output on a zero image
(mean-pooled 4 → 1 along the tokens with ``vit_down``, computed once per
image size and kept), maps both through the resampler to prompt embeds
and pooled embeds, runs the Euler (or any ``schedulers``) loop with the
UNet at batch 2B, decodes the latents with the VAE and returns PIL
images. The reference compiles the step loop into one ``lax.fori_loop``;
here it is a Python loop of UNet forwards, each of whose attentions is K1
on the GPU. The latents and the scheduler's state stay fp32 whatever the
modules compute in, and ε is taken to fp32 before the guidance and the
step. The first noise comes from a ``torch.Generator`` seeded with
``seed`` (``jax.random``'s draw is not reproduced; ``latents`` takes a
given draw instead). The reference's worker builds the adapter without a
``visual_encoder`` and so cannot serve (ROADMAP, known issues of the
reference); the port's factory passes the SEED model's own.

``SDXLAdapterWithLatentImage`` (SEED-X-Edit) feeds the 8-channel UNet the
noise latents beside the VAE's posterior mean of an input image (no
scaling factor, as the reference) and guides three ways: the UNet at batch
3B over [uncond, image-only, full], ε = e_unc + s_img·(e_img − e_unc) +
s·(e_full − e_img). ``IPAdapterSDPipe`` runs an SD-1.5 UNet whose
cross-attention takes the resampler's image tokens after the text tokens
(zeros of ``text_context_len`` without a text encoder).

Training: ``loss_fn`` (the MSE on ε, the resampler → the UNet) on the
adapter's modules; the trainable set is a rule on the port's names
(``parts``: ``unet.*``, ``resampler.*``), the reference's regexes rewritten
for them (``*_trainable_patterns``; ``train.train_state.
apply_frozen_patterns`` marks the parameters). The plain ``Resampler``
returns one tensor: ``get_image_embeds`` then has no pooled embeds, which
the SD-2.1 UNet does not take (the reference unpacks the tensor as a pair;
ROADMAP, known issues of the reference).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
from PIL import Image
from torch import nn

from mllm_npu_tpu_torch.models.generation.schedulers import (
    EulerDiscreteScheduler)


def compute_time_ids(original_size, crops_coords_top_left,
                     target_resolution) -> np.ndarray:
    """SDXL's six micro-conditioning ids [1, 6] (reference :38)."""
    target_size = (target_resolution, target_resolution)
    return np.asarray([list(original_size) + list(crops_coords_top_left)
                       + list(target_size)], np.float32)


def _postprocess_u8(imgs: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images [B, 3, H, W] → uint8 [B, H, W, 3] on their device,
    so the host copy moves 3 bytes a pixel."""
    x = torch.clamp(imgs.float() / 2 + 0.5, 0.0, 1.0)
    return torch.round(x * 255.0).to(torch.uint8).permute(0, 2, 3, 1)


def _to_pil(arr: np.ndarray) -> Image.Image:
    """One uint8 [H, W, 3] image (``_postprocess_u8``'s) → PIL."""
    return Image.fromarray(arr)


def adapter_trainable_patterns(full_ft: bool = False) -> tuple:
    """Frozen-parameter regexes over ``parts``' names: the UNet frozen but
    its cross-attentions' ``to_k`` / ``to_v`` (reference :46,
    ``unet/(?!.*attn2/to_[kv]/).*``); nothing frozen with ``full_ft``."""
    if full_ft:
        return ()
    return (r"^unet\.(?!.*attn2\.to_[kv]\.).*",)


def _timer(dev):
    """→ a clock that synchronises the device first (on the GPU)."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def now():
        sync()
        return time.perf_counter()
    return now


def _noise(shape, seed, dev, latents, sigma):
    """The first latents: ``latents`` or a seeded standard-normal draw,
    fp32 × the scheduler's initial sigma."""
    if latents is None:
        g = torch.Generator(device=dev)
        g.manual_seed(seed if seed is not None else 0)
        latents = torch.randn(shape, generator=g, device=dev)
    return latents.to(dev, torch.float32) * sigma


def guided_denoise(unet, sched, latents, num_inference_steps: int, ways: int,
                   combine, extra_channels=None, **cond):
    """The classifier-free-guidance loop (the reference's ``_denoise_fn``
    bodies without the VAE): each step runs ``unet`` once at batch
    ``ways``·B on the scaled latents repeated ``ways`` times (then
    ``extra_channels`` beside them along the channels), ``cond`` its other
    arguments; ``combine`` takes the ``ways`` fp32 ε chunks, in the batch's
    order, to the guided ε. fp32 latents in and out."""
    ts, sigmas = sched.make_schedule(num_inference_steps,
                                     device=latents.device)
    B = latents.shape[0]
    lat, state = latents, sched.init_state(latents)
    for i in range(num_inference_steps):
        lat_in = sched.scale_model_input(torch.cat([lat] * ways), sigmas[i])
        if extra_channels is not None:
            lat_in = torch.cat([lat_in, extra_channels.to(lat_in.dtype)],
                               dim=1)
        eps = unet(lat_in, ts[i].expand(ways * B), **cond).float()
        lat, state = sched.step(combine(eps.chunk(ways)), lat, i, ts, sigmas,
                                state)
    return lat


def _decoded(vae, lat):
    """fp32 latents → uint8 [B, H, W, 3] on the host."""
    imgs = vae.decode(lat / vae.config.scaling_factor)
    return _postprocess_u8(imgs).cpu().numpy()


def load_adapter_checkpoint(unet, resampler, path) -> None:
    """The reference's de-tokenizer checkpoint (``resampler.*`` and
    ``unet.*``, ``utils.weights.split_adapter_state``) into the built
    modules: the resampler whole and strict, the UNet's keys (a whole UNet
    or a tuned subset) merged key by key, strictly (an unknown key or a
    shape that differs raises)."""
    from mllm_npu_tpu_torch.utils import weights as W
    from mllm_npu_tpu_torch.utils.checkpoint_files import load_hf_dir_or_file
    res_sd, unet_sd = W.split_adapter_state(load_hf_dir_or_file(path))
    if res_sd:
        resampler.load_state_dict(res_sd, strict=True)
    if unet_sd:
        state: dict = {}
        W.merge_partial_state(state, unet_sd, {
            k: v.shape for k, v in unet.state_dict().items()},
            f"{path} (unet.*)")
        unet.load_state_dict(state, strict=False)


class SDXLAdapter:
    """The resampler and the UNet, with the VAE, the scheduler, the
    vision encoder for the negative and the discrete front-end set by
    :meth:`init_pipe`. ``last_timings`` holds the wall times of the last
    :meth:`generate` (each ending in a device synchronisation on the GPU):
    the embeds (the negative and the resampler), the denoise loop and its
    steps, and the VAE decode with the post-processing."""

    def __init__(self, *, unet, resampler, vit_down: bool = False):
        self.unet = unet
        self.resampler = resampler
        self.vit_down = vit_down
        self.vae = None
        self.scheduler: Optional[EulerDiscreteScheduler] = None
        self.visual_encoder = None
        self.discrete_model = None
        self._negatives: dict = {}
        self.last_timings: dict = {}
        # the trained modules under the reference's tree names
        self.parts = nn.ModuleDict({"unet": unet, "resampler": resampler})

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @classmethod
    def from_pretrained(cls, unet, resampler, pretrained_model_path=None,
                        **kw):
        """The adapter over built modules, the reference's checkpoint
        loaded into them when a path is given (reference :225)."""
        adapter = cls(unet=unet, resampler=resampler, **kw)
        if pretrained_model_path is not None:
            load_adapter_checkpoint(unet, resampler, pretrained_model_path)
        return adapter

    # -- training --------------------------------------------------------

    def loss_fn(self, batch: dict):
        """The MSE on ε (reference :90): ``batch`` noisy_latents [B, 4, h,
        w], timesteps [B], image_embeds [B, L, D], noise, time_ids [B, 6];
        → (fp32 loss, {"noise_pred"})."""
        prompt_embeds, pooled = self.resampler(batch["image_embeds"])
        added = {"text_embeds": pooled, "time_ids": batch["time_ids"]}
        noise_pred = self.unet(batch["noisy_latents"], batch["timesteps"],
                               prompt_embeds, added_cond=added)
        loss = torch.mean((noise_pred.float() - batch["noise"].float()) ** 2)
        return loss, {"noise_pred": noise_pred}

    # -- inference -------------------------------------------------------

    def init_pipe(self, vae, scheduler=None, visual_encoder=None,
                  discrete_model=None, **_):
        self.vae = vae
        self.scheduler = scheduler or EulerDiscreteScheduler()
        self.visual_encoder = visual_encoder
        self.discrete_model = discrete_model
        self._negatives.clear()

    def encode_image_embeds(self, image_embeds):
        return self.resampler(image_embeds)

    def _negative_embeds(self, batch: int, image_size: int):
        """The vision encoder on a zero image (``vit_down``: tokens
        mean-pooled in fours), computed once per ``image_size``."""
        neg = self._negatives.get(image_size)
        if neg is None:
            if self.visual_encoder is None:
                raise ValueError("the zero-image negative needs init_pipe("
                                 "visual_encoder=...)")
            zeros = torch.zeros((1, image_size, image_size, 3),
                                device=self.device)
            neg = self.visual_encoder(zeros)
            if self.vit_down:
                n, L, C = neg.shape
                neg = neg.reshape(n, L // 4, 4, C).mean(dim=2)
            self._negatives[image_size] = neg
        return neg.expand(batch, *neg.shape[1:])

    def get_image_embeds(self, image_embeds=None, image_tensor=None,
                         return_negative: bool = True,
                         image_size: int = 448):
        """→ (prompt_embeds, negative prompt_embeds, pooled, negative
        pooled); the negatives are None without ``return_negative``, the
        pooled ones None where the resampler returns no pooled embeds (a
        plain ``Resampler``)."""
        if image_tensor is not None:
            image_embeds = self.visual_encoder(image_tensor)
        stacked = image_embeds
        if return_negative:
            neg = self._negative_embeds(image_embeds.shape[0], image_size)
            stacked = torch.cat([image_embeds, neg.to(image_embeds.dtype)])
        if self.discrete_model is not None:
            stacked = self.discrete_model(stacked)
        out = self.encode_image_embeds(stacked)
        pe, pooled = out if isinstance(out, tuple) else (out, None)
        if not return_negative:
            return pe, None, pooled, None
        pe, pe_neg = pe.chunk(2)
        pooled, pooled_neg = (None, None) if pooled is None \
            else pooled.chunk(2)
        return pe, pe_neg, pooled, pooled_neg

    @staticmethod
    def _added(pooled, time_ids):
        """The UNet's added conditioning, or None without pooled embeds."""
        if pooled is None:
            return None
        return {"text_embeds": pooled, "time_ids": time_ids}

    def _time_ids(self, B, height, width, dev):
        return torch.as_tensor(np.repeat(
            compute_time_ids((height, width), (0, 0), height), B, axis=0),
            device=dev)

    def denoise(self, latents, pe, pe_neg, pooled, pooled_neg, time_ids,
                guidance_scale: float, num_inference_steps: int):
        """The CFG loop (reference ``_denoise_fn`` :159-199 without the
        VAE): fp32 latents [B, 4, h, w] → fp32 latents. The negative half
        of the UNet's batch comes first."""
        added = self._added(
            None if pooled is None else torch.cat([pooled_neg, pooled]),
            torch.cat([time_ids, time_ids]))
        return guided_denoise(
            self.unet, self.scheduler, latents, num_inference_steps, 2,
            lambda e: e[0] + guidance_scale * (e[1] - e[0]),
            encoder_hidden_states=torch.cat([pe_neg, pe]), added_cond=added)

    @torch.inference_mode()
    def generate(self, image_embeds=None, image_tensor=None, seed=42,
                 height: int = 1024, width: int = 1024,
                 guidance_scale: float = 7.5,
                 num_inference_steps: int = 30, input_image_size: int = 448,
                 latents: Optional[torch.Tensor] = None):
        """Features [B, L, D] (or images through the vision encoder) →
        B PIL images of ``height`` × ``width``. ``latents`` [B, 4, h, w]
        replaces the seeded standard-normal draw."""
        dev = self.device
        now = _timer(dev)
        t0 = now()
        pe, pe_neg, pooled, pooled_neg = self.get_image_embeds(
            image_embeds=image_embeds, image_tensor=image_tensor,
            return_negative=True, image_size=input_image_size)
        t1 = now()
        B = pe.shape[0]
        f = self.vae.config.spatial_scale_factor
        latents = _noise((B, 4, height // f, width // f), seed, dev, latents,
                         self.scheduler.init_noise_sigma)
        lat = self.denoise(latents, pe, pe_neg, pooled, pooled_neg,
                           self._time_ids(B, height, width, dev),
                           guidance_scale, num_inference_steps)
        t2 = now()
        u8 = _decoded(self.vae, lat)
        t3 = time.perf_counter()
        self.last_timings = {"embeds_s": t1 - t0, "denoise_s": t2 - t1,
                             "steps": num_inference_steps,
                             "vae_s": t3 - t2, "total_s": t3 - t0}
        return [_to_pil(a) for a in u8]


class SDXLAdapterWithLatentImage(SDXLAdapter):
    """The 8-channel edit variant (SEED-X-Edit; reference :239): the UNet
    input is the noise latents beside the input image's latents, guided
    three ways (module docstring)."""

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        """An input image [B, 3, H, W] in [-1, 1] → the VAE's posterior
        mean [B, 4, H/8, W/8], fp32, unscaled (reference :258-266)."""
        return self.vae.encode(image.to(self.device)).float()

    def denoise3(self, latents, prompt, pooled_all, time_ids, img_lat_all,
                 guidance_scale: float, image_guidance_scale: float,
                 num_inference_steps: int):
        """The three-way CFG loop (reference ``_denoise3_fn`` :288 without
        the VAE): the UNet's batch of 3B is [uncond, image-only, full] in
        ``prompt``, ``pooled_all``, ``time_ids`` and ``img_lat_all``."""
        def combine(e):
            e_unc, e_img, e_full = e
            return (e_unc + image_guidance_scale * (e_img - e_unc)
                    + guidance_scale * (e_full - e_img))
        return guided_denoise(
            self.unet, self.scheduler, latents, num_inference_steps, 3,
            combine, extra_channels=img_lat_all,
            encoder_hidden_states=prompt,
            added_cond=self._added(pooled_all, time_ids))

    def guidance_batch(self, pe, pe_neg, pooled, pooled_neg, time_ids,
                       image_latents):
        """The three-way batch's conditioning: (prompt, pooled, time ids,
        image latents), each [uncond; image-only; full] (reference
        :271-279)."""
        prompt = torch.cat([pe_neg, pe_neg, pe])
        pooled_all = None if pooled is None else torch.cat(
            [pooled_neg, pooled_neg, pooled])
        img_lat_all = torch.cat([torch.zeros_like(image_latents),
                                 image_latents, image_latents])
        return prompt, pooled_all, torch.cat([time_ids] * 3), img_lat_all

    @torch.inference_mode()
    def generate(self, image_embeds=None, latent_image=None, seed=42,
                 height: int = 1024, width: int = 1024,
                 guidance_scale: float = 7.5,
                 image_guidance_scale: float = 1.5,
                 num_inference_steps: int = 30, input_image_size: int = 448,
                 latents: Optional[torch.Tensor] = None):
        """Features [B, L, D] and the image to edit (``latent_image``, the
        reference's name: [B, 3, H, W] in [-1, 1], VAE-encoded here; None:
        zero latents) → B PIL images. ``last_timings`` adds the encode."""
        dev = self.device
        now = _timer(dev)
        t0 = now()
        pe, pe_neg, pooled, pooled_neg = self.get_image_embeds(
            image_embeds=image_embeds, return_negative=True,
            image_size=input_image_size)
        t1 = now()
        B = pe.shape[0]
        f = self.vae.config.spatial_scale_factor
        shape = (B, 4, height // f, width // f)
        latents = _noise(shape, seed, dev, latents,
                         self.scheduler.init_noise_sigma)
        image_latents = (torch.zeros(shape, device=dev)
                         if latent_image is None
                         else self.encode_image(latent_image))
        t2 = now()
        lat = self.denoise3(latents, *self.guidance_batch(
            pe, pe_neg, pooled, pooled_neg,
            self._time_ids(B, height, width, dev), image_latents),
            guidance_scale, image_guidance_scale, num_inference_steps)
        t3 = now()
        u8 = _decoded(self.vae, lat)
        t4 = time.perf_counter()
        self.last_timings = {"embeds_s": t1 - t0, "encode_s": t2 - t1,
                             "denoise_s": t3 - t2,
                             "steps": num_inference_steps, "vae_s": t4 - t3,
                             "total_s": t4 - t0}
        return [_to_pil(a) for a in u8]


class SDXLText2ImageAndEditAdapter(SDXLAdapterWithLatentImage):
    """The LoRA t2i + edit variant (reference :347): build the UNet with
    ``UNetConfig(lora_rank=...)`` and 8 input channels. Trainable: the
    resampler and the LoRA adapters, and the first down block with
    ``train_down_block``."""

    @staticmethod
    def trainable_patterns(train_down_block: bool = True) -> tuple:
        """Frozen-parameter regexes over ``parts``' names (reference :355,
        ``unet/(?!(down_0_|.*lora_[ab]$))``: the reference's ``down_0_``
        blocks are the port's ``down_blocks.0``)."""
        if train_down_block:
            return (r"^unet\.(?!(down_blocks\.0\.|.*lora_[AB]\.weight$))",)
        return (r"^unet\.(?!.*lora_[AB]\.weight$)",)


class SD21Text2ImageAndEditAdapter(SDXLText2ImageAndEditAdapter):
    """The SD-2.1 variant (reference :362) over ``UNetConfig.sd21()``,
    which takes no added conditioning, paired with a plain ``Resampler``:
    the prompt embeds alone."""


# -- the IP-Adapter (SD-1.5, decoupled image cross-attention) ----------------

@torch.no_grad()
def init_ip_adapter_params(unet: nn.Module) -> nn.Module:
    """Copy each cross-attention's ``to_k`` / ``to_v`` tensors into its
    ``to_k_ip`` / ``to_v_ip`` (reference :371), in place; the UNet is built
    with ``UNetConfig(ip_num_image_tokens > 0)``. → ``unet``."""
    state = unet.state_dict()
    for key, t in state.items():
        for src, dst in ((".attn2.to_k.", ".attn2.to_k_ip."),
                         (".attn2.to_v.", ".attn2.to_v_ip.")):
            ip = key.replace(src, dst)
            if src in key and ip in state:
                state[ip].copy_(t)
    return unet


def ip_adapter_trainable_patterns() -> tuple:
    """Frozen-parameter regexes: the UNet but its ``to_k_ip`` / ``to_v_ip``
    (reference :391, ``unet/(?!.*to_[kv]_ip/).*``); the resampler trains."""
    return (r"^unet\.(?!.*to_[kv]_ip\.).*",)


def _tokens(out):
    """A resampler's image tokens (an XL resampler's prompt embeds)."""
    return out[0] if isinstance(out, tuple) else out


class IPAdapterSD:
    """The IP-Adapter over an SD-1.5-class UNet (reference :398): image
    features → the resampler → ``ip_num_image_tokens`` tokens after the
    text context, which every cross-attention attends separately."""

    def __init__(self, *, unet, resampler):
        if unet.config.ip_num_image_tokens <= 0:
            raise ValueError("build the UNet with UNetConfig("
                             "ip_num_image_tokens=N)")
        self.unet = unet
        self.resampler = resampler
        self.parts = nn.ModuleDict({"unet": unet, "resampler": resampler})

    @property
    def num_image_tokens(self) -> int:
        return self.unet.config.ip_num_image_tokens

    def encode_image_embeds(self, image_embeds):
        """(reference :421)."""
        return _tokens(self.resampler(image_embeds)).to(image_embeds.dtype)

    def loss_fn(self, batch: dict):
        """The MSE on ε (reference :429): ``batch`` noisy_latents, timesteps,
        image_embeds, text_embeds [B, T, ctx], noise → (fp32 loss,
        {"noise_pred"})."""
        text = batch["text_embeds"]
        tokens = _tokens(self.resampler(batch["image_embeds"]))
        context = torch.cat([text, tokens.to(text.dtype)], dim=1)
        noise_pred = self.unet(batch["noisy_latents"], batch["timesteps"],
                               context)
        loss = torch.mean((noise_pred.float() - batch["noise"].float()) ** 2)
        return loss, {"noise_pred": noise_pred}

    @classmethod
    def from_pretrained(cls, unet, resampler, pretrained_model_path=None,
                        seed_ip_from_unet: bool = True, **kw):
        """(reference :449): the image projections seeded from the UNet's
        own, then the checkpoint loaded where a path is given."""
        if seed_ip_from_unet:
            init_ip_adapter_params(unet)
        adapter = cls(unet=unet, resampler=resampler, **kw)
        if pretrained_model_path is not None:
            load_adapter_checkpoint(unet, resampler, pretrained_model_path)
        return adapter


class IPAdapterSDPipe:
    """The IP-Adapter's inference pipe (reference :465): image → the vision
    encoder → the discrete model → the resampler → image tokens; CFG with a
    zero-image negative; the text context as given ``prompt_embeds``, or
    zeros of ``text_context_len`` (the port has no text encoder)."""

    def __init__(self, *, ip_adapter: IPAdapterSD, discrete_model=None,
                 vae=None, visual_encoder=None, image_transform=None,
                 scheduler=None, text_context_len: int = 77):
        self.ip_adapter = ip_adapter
        self.discrete_model = discrete_model
        self.vae = vae
        self.visual_encoder = visual_encoder
        self.image_transform = image_transform
        self.scheduler = scheduler or EulerDiscreteScheduler()
        self.text_context_len = text_context_len
        self.ip_scale = 1.0
        self.last_timings: dict = {}

    def set_scale(self, scale: float):
        """The IP branch's mixing scale, an argument of each UNet call
        (reference :492)."""
        self.ip_scale = float(scale)

    def get_image_embeds(self, image_pil=None, image_tensor=None,
                         return_negative: bool = True):
        """Image tokens of the image [B, H, W, 3] (or ``image_pil`` through
        ``image_transform``) and of a zero image, in one pass → (pos, neg)
        (reference :497)."""
        dev = self.ip_adapter.unet.conv_in.weight.device
        if image_pil is not None:
            image_tensor = torch.as_tensor(np.asarray(
                self.image_transform(image_pil)))[None]
        image_tensor = image_tensor.to(dev)
        if return_negative:
            image_tensor = torch.cat([image_tensor,
                                      torch.zeros_like(image_tensor)])
        embeds = self.visual_encoder(image_tensor)
        if self.discrete_model is not None:
            embeds = self.discrete_model(embeds)
        tokens = self.ip_adapter.encode_image_embeds(embeds)
        if return_negative:
            return tuple(tokens.chunk(2))
        return tokens, None

    @torch.inference_mode()
    def generate(self, image_pil=None, image_tensor=None, prompt_embeds=None,
                 negative_prompt_embeds=None, scale: float = 1.0,
                 num_samples: int = 1, seed=42, guidance_scale: float = 7.5,
                 num_inference_steps: int = 30, height: int = 512,
                 width: int = 512, latents: Optional[torch.Tensor] = None):
        """(reference :556) → B·``num_samples`` PIL images; ``latents``
        replaces the seeded draw."""
        unet = self.ip_adapter.unet
        dev = unet.conv_in.weight.device
        now = _timer(dev)
        t0 = now()
        self.set_scale(scale)
        ip_pos, ip_neg = self.get_image_embeds(image_pil=image_pil,
                                               image_tensor=image_tensor)
        if num_samples > 1:
            ip_pos = ip_pos.repeat_interleave(num_samples, dim=0)
            ip_neg = ip_neg.repeat_interleave(num_samples, dim=0)
        B = ip_pos.shape[0]
        if prompt_embeds is None:
            prompt_embeds = torch.zeros(
                (B, self.text_context_len, unet.config.cross_attention_dim),
                device=dev)
        if negative_prompt_embeds is None:
            negative_prompt_embeds = torch.zeros_like(prompt_embeds)
        dt = prompt_embeds.dtype
        context = torch.cat([
            torch.cat([negative_prompt_embeds, ip_neg.to(dt)], dim=1),
            torch.cat([prompt_embeds, ip_pos.to(dt)], dim=1)])
        f = self.vae.config.spatial_scale_factor
        latents = _noise((B, 4, height // f, width // f), seed, dev, latents,
                         self.scheduler.init_noise_sigma)
        t1 = now()
        lat = guided_denoise(
            unet, self.scheduler, latents, num_inference_steps, 2,
            lambda e: e[0] + guidance_scale * (e[1] - e[0]),
            encoder_hidden_states=context, ip_scale=self.ip_scale)
        t2 = now()
        u8 = _decoded(self.vae, lat)
        t3 = time.perf_counter()
        self.last_timings = {"embeds_s": t1 - t0, "denoise_s": t2 - t1,
                             "steps": num_inference_steps, "vae_s": t3 - t2,
                             "total_s": t3 - t0}
        return [_to_pil(a) for a in u8]
