"""The model side of the seven benchmarks (twin of
``mllm_npu_tpu/evaluate/evaluator.py``):

- ``generate_text(prompt, max_new_tokens)``: greedy decode of a text
  prompt (MMLU, CMMLU, C-Eval, BBH); ``generate_text_many`` sends a
  subject's prompts concurrently through a batched engine;
- ``generate_with_image(query, img_path)``: an anyres-tiled image and a
  question through ``InferenceEngine.comprehension`` (MME, MM-Vet);
- ``lm_loss(text, image_paths)``: one forward of the assembly on an
  interleaved sample, for ranking choices by loss (SEED-Bench2).
"""

from __future__ import annotations

import base64
import concurrent.futures
import dataclasses
import io
import re

import numpy as np
import torch
from PIL import Image

from mllm_npu_tpu_torch.constant import (BOI_TOKEN, BOP_TOKEN, EOP_TOKEN,
                                         IGNORE_INDEX, image_tokens_str)
from mllm_npu_tpu_torch.data.utils import process_anyres_image


class EvalModel:
    """An ``InferenceEngine`` (or ``BatchedInferenceEngine``) and the model
    ``lm_loss`` runs: ``model``, or the engine's served model.

    The engine's generator stores the model's fp32 parameters in bf16, as
    the reference's serving does, so on a bf16 engine the loss is computed
    from the same bf16 products as the reference's. A quantized or fused
    engine's model holds int8/int4 or fused weights, which the reference's
    loss never sees (it runs the unconverted ``params``): ``lm_loss``
    raises on such a model, and takes an unconverted one as ``model``."""

    def __init__(self, engine, model=None, max_length: int = 1024):
        self.engine = engine
        self.model = model if model is not None else engine.generator.model
        self.tokenizer = engine.tokenizer
        self.max_length = max_length

    # ---- text-only generation (mmlu/cmmlu/bbh/ceval) ----------------------

    def _prompt_ids(self, prompt: str) -> list:
        tok = self.tokenizer
        return [tok.bos_token_id] + tok.encode(prompt,
                                               add_special_tokens=False)

    def generate_text(self, prompt: str, max_new_tokens: int = 10) -> str:
        ids = self._prompt_ids(prompt)
        if hasattr(self.engine, "generate_ids"):
            # the batched engine: with a prefix cache, the few-shot
            # preamble every item repeats prefills once
            toks = self.engine.generate_ids(ids, max_new_tokens)
            return self.engine._decode_text(toks)
        gen = self.engine.generator
        # a per-call sampling config: the shared generator is not changed,
        # and its captured decode step is keyed on the static shape only
        out = gen.generate(
            torch.as_tensor(ids, dtype=torch.long,
                            device=self.engine.device)[None],
            sampling=dataclasses.replace(gen.sampling,
                                         max_new_tokens=max_new_tokens))
        return self.engine._decode_text(
            out["generate_ids"][0].cpu().numpy())

    def supports_concurrent_text(self) -> bool:
        return hasattr(self.engine, "generate_ids")

    def generate_text_many(self, prompts, max_new_tokens: int = 10):
        """The prompts through the batched engine at once: they decode
        together in its slots (and reuse a shared preamble's cached
        prefix). Greedy rows do not depend on each other, so the texts are
        the serial loop's."""
        def one(p):
            return self.engine._decode_text(
                self.engine.generate_ids(self._prompt_ids(p),
                                         max_new_tokens))

        # generate_ids blocks until its request is done; eight threads keep
        # the engine's slots filled (its drain thread makes every device
        # call)
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            return list(ex.map(one, prompts))

    # ---- image comprehension (mme/mmvet) ----------------------------------

    def generate_with_image(self, query: str, img_path: str,
                            prompt_template: str =
                            "Question: {}\nAnswer:") -> str:
        """The image re-encoded as JPEG (PIL's defaults) and the query
        through ``engine.comprehension``, which builds the anyres prompt;
        ``prompt_template`` is not used, as in the reference."""
        image = Image.open(img_path).convert("RGB")
        buf = io.BytesIO()
        image.save(buf, format="JPEG")
        b64 = base64.b64encode(buf.getvalue()).decode()
        return self.engine.comprehension(query, b64)

    # ---- loss ranking (seed_bench2) ---------------------------------------

    def loss_inputs(self, text: str, image_paths: list) -> dict:
        """The assembly's keyword inputs for :meth:`lm_loss` (numpy), where
        each ``<img>`` in ``text`` marks one image (anyres-tiled): BOS, the
        parts with each image's ``<patch>`` tiles and ``<img>`` span, EOS,
        cut to ``max_length``; the image tokens unsupervised; a blank
        image when there is none."""
        tok = self.tokenizer
        eng = self.engine
        parts = text.split(BOI_TOKEN)
        if len(parts) != len(image_paths) + 1:
            raise ValueError(f"{len(parts) - 1} <img> tags vs "
                             f"{len(image_paths)} images")

        input_ids = [tok.bos_token_id]
        all_patches, all_pos = [], []
        for i, part in enumerate(parts):
            if i > 0:
                image = Image.open(image_paths[i - 1]).convert("RGB")
                patches, pos = process_anyres_image(
                    image, eng.image_transform, eng.grid_pinpoints,
                    eng.base_resolution)
                n = patches.shape[0]
                all_patches.append(patches)
                all_pos.append(pos)
                toks = "".join(
                    image_tokens_str(eng.num_img_in_tokens, BOP_TOKEN,
                                     EOP_TOKEN) for _ in range(n - 1))
                toks += image_tokens_str(eng.num_img_in_tokens)
                input_ids.extend(tok.encode(toks, add_special_tokens=False))
            if part:
                input_ids.extend(tok.encode(part,
                                            add_special_tokens=False))
        input_ids.append(tok.eos_token_id)
        # truncated before the compare mask is built, as the reference
        input_ids = np.asarray(input_ids[:self.max_length], np.int32)

        ids_cmp_mask = np.zeros_like(input_ids, bool)
        starts = np.where((input_ids == eng.boi) | (input_ids == eng.bop))[0]
        ends = np.where((input_ids == eng.eoi) | (input_ids == eng.eop))[0]
        for b, e in zip(starts, ends):
            ids_cmp_mask[b + 1:e] = True

        images = (np.concatenate(all_patches, axis=0) if all_patches
                  else np.zeros((1,) + (eng.image_transform.image_size,) * 2
                                + (3,), np.float32))
        pos = (np.concatenate(all_pos, axis=0) if all_pos
               else np.full((1, 2), 0.5, np.float32))
        n = images.shape[0]

        labels = input_ids.copy()
        labels[ids_cmp_mask] = IGNORE_INDEX
        return {"input_ids": input_ids[None].astype(np.int64),
                "images": images,
                "attention_mask": np.ones((1, len(input_ids)), np.int32),
                "labels": labels[None].astype(np.int64),
                "embeds_gen_mask": np.zeros((n,), bool),
                "embeds_cmp_mask": np.ones((n,), bool),
                "ids_gen_mask": np.zeros_like(ids_cmp_mask[None]),
                "ids_cmp_mask": ids_cmp_mask[None],
                "patch_positions": pos}

    def lm_loss(self, text: str, image_paths: list) -> float:
        """Forward loss on an interleaved sample where each '<img>' in
        ``text`` marks one image (anyres-tiled): one causal pass of the
        assembly (``models/mllm.py forward``; K1 on the GPU) without a
        gradient."""
        model = self.model
        cfg = model.language_model.config
        if cfg.quantization != "none" or cfg.fused_projections:
            raise ValueError(
                f"lm_loss on a model served with quantization="
                f"{cfg.quantization!r}, fused_projections="
                f"{cfg.fused_projections}: the reference scores unconverted "
                "weights; pass EvalModel(model=...) an unconverted model")
        dev = next(model.parameters()).device
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in self.loss_inputs(text, image_paths).items()}
        with torch.inference_mode():
            out = model(**batch)
        return float(out["lm_loss"])


def strip_special(text: str) -> str:
    text = re.sub(r"<[^>]*>", "", text)
    text = re.sub(r"\[(.*)\]", "", text)
    return text
