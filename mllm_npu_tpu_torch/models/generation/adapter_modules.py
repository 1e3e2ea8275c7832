"""The SDXL de-tokenizer: image features → image (twin of ``SDXLAdapter``,
``compute_time_ids``, ``_postprocess_u8`` and ``_to_pil`` in
``mllm_npu_tpu/models/generation/adapter_modules.py``).

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
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
from PIL import Image

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

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

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
        pooled); the negatives are None without ``return_negative``."""
        if image_tensor is not None:
            image_embeds = self.visual_encoder(image_tensor)
        stacked = image_embeds
        if return_negative:
            neg = self._negative_embeds(image_embeds.shape[0], image_size)
            stacked = torch.cat([image_embeds, neg.to(image_embeds.dtype)])
        if self.discrete_model is not None:
            stacked = self.discrete_model(stacked)
        pe, pooled = self.encode_image_embeds(stacked)
        if return_negative:
            pe, pe_neg = pe.chunk(2)
            pooled, pooled_neg = pooled.chunk(2)
            return pe, pe_neg, pooled, pooled_neg
        return pe, None, pooled, None

    def denoise(self, latents, pe, pe_neg, pooled, pooled_neg, time_ids,
                guidance_scale: float, num_inference_steps: int):
        """The CFG loop (reference ``_denoise_fn`` :159-199 without the
        VAE): fp32 latents [B, 4, h, w] → fp32 latents. The negative half
        of the UNet's batch comes first."""
        sched = self.scheduler
        ts, sigmas = sched.make_schedule(num_inference_steps,
                                         device=latents.device)
        B = latents.shape[0]
        prompt = torch.cat([pe_neg, pe])
        added = {"text_embeds": torch.cat([pooled_neg, pooled]),
                 "time_ids": torch.cat([time_ids, time_ids])}
        lat, state = latents, sched.init_state(latents)
        for i in range(num_inference_steps):
            lat_in = sched.scale_model_input(torch.cat([lat, lat]),
                                             sigmas[i])
            eps = self.unet(lat_in, ts[i].expand(2 * B), prompt,
                            added_cond=added).float()
            eps_neg, eps_pos = eps.chunk(2)
            eps = eps_neg + guidance_scale * (eps_pos - eps_neg)
            lat, state = sched.step(eps, lat, i, ts, sigmas, state)
        return lat

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
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        t0 = time.perf_counter()
        pe, pe_neg, pooled, pooled_neg = self.get_image_embeds(
            image_embeds=image_embeds, image_tensor=image_tensor,
            return_negative=True, image_size=input_image_size)
        sync()
        t1 = time.perf_counter()
        B = pe.shape[0]
        f = self.vae.config.spatial_scale_factor
        shape = (B, 4, height // f, width // f)
        if latents is None:
            g = torch.Generator(device=dev)
            g.manual_seed(seed if seed is not None else 0)
            latents = torch.randn(shape, generator=g, device=dev)
        latents = latents.to(dev, torch.float32) \
            * self.scheduler.init_noise_sigma
        time_ids = torch.as_tensor(np.repeat(
            compute_time_ids((height, width), (0, 0), height), B, axis=0),
            device=dev)
        lat = self.denoise(latents, pe, pe_neg, pooled, pooled_neg,
                           time_ids, guidance_scale, num_inference_steps)
        sync()
        t2 = time.perf_counter()
        imgs = self.vae.decode(lat / self.vae.config.scaling_factor)
        u8 = _postprocess_u8(imgs).cpu().numpy()
        t3 = time.perf_counter()
        self.last_timings = {"embeds_s": t1 - t0, "denoise_s": t2 - t1,
                             "steps": num_inference_steps,
                             "vae_s": t3 - t2, "total_s": t3 - t0}
        return [_to_pil(a) for a in u8]
