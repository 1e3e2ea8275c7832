"""Greedy decoding with the forced image-token ladder (twin of
``mllm_npu_tpu/models/generation/sampler.py``: ``ImageTokenLadder``,
``ladder_from_tokenizer``, ``apply_image_ladder``, greedy ``_sample`` and
``decode_loop``). Sampled decoding (temperature, top-p, the batched
engine's per-slot ``sample_rows``) is not ported yet (ROADMAP queue 1 item
10b).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from mllm_npu_tpu_torch.constant import BOI_TOKEN, EOI_TOKEN, IMG_TOKEN

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    max_new_tokens: int = 120
    eos_token_id: int = -1
    pad_token_id: int = 0


@dataclasses.dataclass(frozen=True)
class ImageTokenLadder:
    """Token ids of [<img>, <img_00000>, ..., <img_NNNNN>, </img>]."""
    ids: tuple
    # the ids as a tensor, one per device, copied there on first use
    _on_device: dict = dataclasses.field(default_factory=dict, compare=False,
                                         repr=False)

    def ids_on(self, device: torch.device) -> torch.Tensor:
        """The ids as a long tensor on ``device``, built once: a decode
        step then makes no host-to-device copy (a CUDA graph cannot hold
        one)."""
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = torch.tensor(self.ids, dtype=torch.long,
                                                   device=device)
        return self._on_device[device]

    @property
    def boi(self) -> int:
        return self.ids[0]

    @property
    def eoi(self) -> int:
        return self.ids[-1]


def ladder_from_tokenizer(tokenizer, num_img_gen_tokens: int = 64
                          ) -> ImageTokenLadder:
    text = "".join([BOI_TOKEN] + [IMG_TOKEN.format(i)
                                  for i in range(num_img_gen_tokens)]
                   + [EOI_TOKEN])
    ids = tokenizer.encode(text, add_special_tokens=False)
    if len(ids) != num_img_gen_tokens + 2:
        raise ValueError("image ladder tokens must each encode to one id")
    return ImageTokenLadder(ids=tuple(ids))


def apply_image_ladder(logits: torch.Tensor, last_token: torch.Tensor,
                       ladder: ImageTokenLadder) -> torch.Tensor:
    """If the last token is in the ladder (except its final ``</img>``),
    force its successor; otherwise suppress the non-initial ladder tokens.
    logits [B, V] fp32, last_token [B]."""
    ids = ladder.ids_on(logits.device)
    prev_ids, next_ids = ids[:-1], ids[1:]
    eq = last_token[:, None].long() == prev_ids[None, :]      # [B, L-1]
    in_ladder = eq.any(dim=-1)
    forced_next = (eq.long() * next_ids[None, :]).sum(dim=-1)
    # index_fill takes the fill as a scalar: no host tensor to copy (which
    # a CUDA graph could not hold)
    suppressed = logits.index_fill(1, next_ids, NEG_INF)
    forced = torch.full_like(logits, NEG_INF)
    forced.scatter_(1, forced_next[:, None],
                    logits.max(dim=-1, keepdim=True).values + 10.0)
    return torch.where(in_ladder[:, None], forced, suppressed)


def _sample(logits: torch.Tensor) -> torch.Tensor:
    """Greedy: the first index of the row maximum (as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1)


def decode_loop(step_fn: Callable, cache, first_token: torch.Tensor,
                cfg: SamplingConfig,
                ladder: Optional[ImageTokenLadder] = None):
    """step_fn(token [B, 1], cache) → (logits [B, V] fp32, cache).

    Returns (tokens [B, max_new_tokens], done [B], steps run): the first
    token from the prefill, then one per step until every row has emitted
    EOS; a row pads with ``pad_token_id`` after its EOS, and steps after
    all rows are done are not run (their columns stay 0, as in the
    reference)."""
    B = first_token.shape[0]
    T = cfg.max_new_tokens
    tokens = torch.zeros((B, T), dtype=torch.long, device=first_token.device)
    tokens[:, 0] = first_token
    done = first_token == cfg.eos_token_id
    t = 1
    while t < T and not bool(done.all()):
        cur = tokens[:, t - 1:t]
        logits, cache = step_fn(cur, cache)
        if ladder is not None:
            logits = apply_image_ladder(logits, cur[:, 0], ladder)
        nxt = _sample(logits)
        nxt = torch.where(done, torch.full_like(nxt, cfg.pad_token_id), nxt)
        tokens[:, t] = nxt
        done = done | (nxt == cfg.eos_token_id)
        t += 1
    return tokens, done, t - 1
