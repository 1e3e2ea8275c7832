"""Decoding with the forced image-token ladder: greedy, sampled and
prompt-lookup speculative (twin of
``mllm_npu_tpu/models/generation/sampler.py``: ``ImageTokenLadder``,
``ladder_from_tokenizer``, ``apply_image_ladder``, ``ladder_propose``,
``sample_rows``, ``_sample``, ``speculative_decode_loop`` and
``extract_img_windows``; the one-token ``decode_loop`` is
``generate.py DecodeStep``). The decode loops return each emitted token's
hidden state beside it, from which the SEED path cuts the image windows.

Random numbers: ``jax.random``'s bits are not reproduced. A sampled row's
draw for one token is Gumbel-max over its filtered logits, the Gumbel
noise a counter-based hash of (the row's seed, the token's index in its
output, the vocabulary index) computed in int64 tensor ops
(:func:`gumbel_noise`). It reads no generator state, so the same row
draws the same token wherever it runs: in any slot, beside any other
rows, eager or replayed from a CUDA graph, on the CPU or the GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from mllm_npu_tpu_torch.constant import BOI_TOKEN, EOI_TOKEN, IMG_TOKEN

NEG_INF = -1e30
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    max_new_tokens: int = 120
    temperature: float = 0.7
    top_p: float = 0.5
    do_sample: bool = False       # the reference's parity default: greedy
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


def ladder_propose(cur: torch.Tensor, props: torch.Tensor,
                   ladder: ImageTokenLadder) -> torch.Tensor:
    """Speculative proposals inside the forced ladder: where the last token
    ``cur`` [B] is in the ladder (except ``</img>``), the next tokens are
    known, so its successor chain replaces the prompt-lookup proposals
    ``props`` [B, k]; positions past the ladder's end keep the caller's."""
    ids = ladder.ids_on(props.device)
    L, k = ids.shape[0], props.shape[-1]
    hit = cur[:, None].long() == ids[None, :-1]               # [B, L-1]
    pos = torch.arange(L - 1, device=props.device)
    idx = torch.where(hit, pos, -1).max(dim=-1).values        # [B]
    src = idx[:, None] + 1 + torch.arange(k, device=props.device)
    from_ladder = ids[src.clamp(0, L - 1)]
    use = (idx[:, None] >= 0) & (src <= L - 1)
    return torch.where(use, from_ladder, props)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche hash of int64 tensors holding 32-bit values
    (lowbias32's shifts; both multipliers below 2^31, so no product leaves
    the int64 range)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seed: torch.Tensor, index: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Gumbel(0, 1) noise [B, vocab] fp32, a function of each row's
    ``seed`` [B] (any int64), ``index`` [B] (the token's index in the
    row's output) and the vocabulary index alone: 23 bits of a hash per
    entry make u in (0, 1) (exact in fp32), the noise is -log(-log(u))."""
    s = (seed ^ (seed >> 32)) & _M32
    key = _mix32(_mix32(s) ^ (_mix32(index & _M32) * 0x2545F491 & _M32))
    v = torch.arange(vocab, device=seed.device, dtype=torch.long)
    h = _mix32(key[:, None] ^ ((v * 0x61C88647) & _M32)[None, :])
    u = ((h >> 9).float() + 0.5) * (1.0 / (1 << 23))
    return -torch.log(-torch.log(u))


def nucleus_filter(logits: torch.Tensor, temperature: torch.Tensor,
                   top_p: torch.Tensor) -> torch.Tensor:
    """Temperature-scaled logits [B, V] with every entry outside the row's
    nucleus set to NEG_INF, as the reference's ``sample_rows``: the sorted
    entries whose preceding mass exceeds top_p are cut, the cutoff is the
    least kept value, and only entries below it are masked (ties at the
    cutoff stay)."""
    scaled = logits / temperature.clamp(min=1e-6)[:, None]
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cut = cum - probs > top_p[:, None]
    cutoff = torch.where(cut, torch.full_like(sorted_logits, float("inf")),
                         sorted_logits).min(dim=-1, keepdim=True).values
    return torch.where(scaled < cutoff, torch.full_like(scaled, NEG_INF),
                       scaled)


def sample_rows(logits: torch.Tensor, seed: torch.Tensor,
                index: torch.Tensor, temperature: torch.Tensor,
                top_p: torch.Tensor, do_sample: torch.Tensor) -> torch.Tensor:
    """Per-row temperature + top-p sampling mixed with greedy rows (the
    reference's ``sample_rows``): logits [B, V] fp32; seed, index [B]
    int64; temperature, top_p [B] fp32; do_sample [B] bool → [B] long.
    A sampled row draws the argmax of its filtered logits plus
    :func:`gumbel_noise`, a greedy row its argmax."""
    greedy = _sample(logits)
    filtered = nucleus_filter(logits, temperature, top_p)
    noise = gumbel_noise(seed, index, logits.shape[-1])
    sampled = torch.argmax(filtered + noise, dim=-1)
    return torch.where(do_sample, sampled, greedy)


def _sample(logits: torch.Tensor) -> torch.Tensor:
    """Greedy: the first index of the row maximum (as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1)


def row_seeds(seed: int, batch: int, device) -> torch.Tensor:
    """One generate call's rows are separate requests: row b draws from
    the stream of (``seed``, b)."""
    return seed * 1_000_003 + torch.arange(batch, device=device,
                                           dtype=torch.long)


def pick(logits: torch.Tensor, cfg: SamplingConfig, seeds: torch.Tensor,
         index: int) -> torch.Tensor:
    """The next token of every row under ``cfg``: greedy, or sampled with
    the rows' ``seeds`` at output index ``index``."""
    if not cfg.do_sample:
        return _sample(logits)
    B = logits.shape[0]
    full = lambda x, dt: torch.full((B,), x, dtype=dt, device=logits.device)
    return sample_rows(logits, seeds, full(index, torch.long),
                       full(cfg.temperature, torch.float32),
                       full(cfg.top_p, torch.float32),
                       full(True, torch.bool))


def lookup_proposals(hist: torch.Tensor, end: torch.Tensor, k: int,
                     ngram: int, pad: int, first: int = 0) -> torch.Tensor:
    """Prompt-lookup proposals for every row: the k tokens that followed
    the latest earlier occurrence of the row's trailing ``ngram``-gram.
    hist [B, N] token history, end [B] its filled length; a match lies
    wholly at or after ``first`` and strictly before the suffix; rows
    without one propose ``pad`` (the reference's proposer, vectorised
    over rows). → [B, k]."""
    B, N = hist.shape
    dev = hist.device
    pos = torch.arange(N, device=dev)
    start = (end - ngram).clamp(0, N - ngram)
    gram = torch.gather(hist, 1, start[:, None] + torch.arange(
        ngram, device=dev))                                   # [B, ngram]
    match = torch.ones((B, N), dtype=torch.bool, device=dev)
    for i in range(ngram):
        s = ngram - 1 - i
        match &= ((torch.roll(hist, s, dims=1) == gram[:, i:i + 1])
                  & (pos >= s))
    match &= pos <= (end - 2)[:, None]
    match &= pos >= first + ngram - 1
    p_star = torch.where(match, pos, -1).max(dim=1).values     # [B]
    src = (p_star + 1).clamp(0, N - k)[:, None] + torch.arange(k, device=dev)
    props = torch.gather(hist, 1, src)
    return torch.where((p_star >= 0)[:, None], props,
                       torch.full_like(props, pad))


def speculative_decode_loop(step_multi: Callable, cache,
                            first_token: torch.Tensor,
                            first_hidden: torch.Tensor, cfg: SamplingConfig,
                            context_ids: torch.Tensor,
                            ladder: Optional[ImageTokenLadder] = None,
                            k: int = 5, ngram: int = 3,
                            prompt_len: Optional[int] = None):
    """Prompt-lookup speculative greedy decode, B = 1 (the reference's
    ``speculative_decode_loop``): each iteration proposes k tokens from
    the context's own history (the ladder's forced chain inside it),
    verifies [cur, proposals] in one forward and keeps the matching
    prefix and the token after it, so the ids equal the one-token decode's
    (``generate.py DecodeStep``).

    step_multi(toks [1, k+1], cache) → (logits [1, k+1, V], hidden
    [1, k+1, D], cache): the forward writes k+1 keys from ``cache["pos"]``
    and advances it by k+1; the loop moves it back over the rejected ones
    (the next verify overwrites them). ``context_ids`` [1, Sp] is the
    right-padded prompt and ``prompt_len`` its real length: the real tokens
    are right-aligned so no n-gram matches across the padding. The cache
    needs k of headroom. Returns (tokens [1, T], hiddens [1, T, D], done
    [1], verify forwards): an emitted token's hidden state is the verify
    forward's row at its position (``first_hidden`` [1, D] the prefill's),
    as the one-token decode's; past the last token both are 0."""
    if cfg.do_sample:
        raise ValueError("speculative decode is greedy-only")
    if first_token.shape[0] != 1:
        raise ValueError("speculative decode takes one row")
    T = cfg.max_new_tokens
    Tp = T + k + 1
    Sp = context_ids.shape[1]
    dev = first_token.device
    tokens = torch.zeros((1, Tp), dtype=torch.long, device=dev)
    hiddens = torch.zeros((1, Tp, first_hidden.shape[-1]),
                          dtype=first_hidden.dtype, device=dev)
    tokens[0, 0] = first_token[0]
    hiddens[0, 0] = first_hidden[0]
    done = int(first_token[0]) == cfg.eos_token_id
    offset = 0 if prompt_len is None else Sp - int(prompt_len)
    ctx0 = torch.roll(context_ids[0].long(), offset)
    cur = first_token[:1].long()
    t, n_iters = 1, 0
    while t < T and not done:
        hist = torch.cat([ctx0, tokens[0]])[None]
        props = lookup_proposals(hist, torch.full((1,), Sp + t, device=dev),
                                 k, ngram, cfg.pad_token_id, first=offset)
        if ladder is not None:
            props = ladder_propose(cur, props, ladder)
        toks_in = torch.cat([cur[:, None], props], dim=1)     # [1, k+1]
        logits, h, cache = step_multi(toks_in, cache)
        lg = logits[0].float()
        if ladder is not None:
            lg = apply_image_ladder(lg, toks_in[0], ladder)
        g = _sample(lg)                                       # [k+1]
        acc = (props[0] == g[:k]).long()
        is_eos = (g == cfg.eos_token_id).nonzero()
        m, eos_idx = int(torch.cumprod(acc, 0).sum()), (
            int(is_eos[0, 0]) if len(is_eos) else k + 1)
        e = min(m + 1, T - t, eos_idx + 1)
        done = eos_idx < e or t + e >= T
        tokens[0, t:t + k + 1] = g
        hiddens[0, t:t + k + 1] = h[0]
        cache["pos"] = cache["pos"] - (k + 1) + e
        cur = g[e - 1:e]
        t += e
        n_iters += 1
    tokens[:, t:] = 0
    hiddens[:, t:] = 0
    return (tokens[:, :T], hiddens[:, :T], torch.tensor([done], device=dev),
            n_iters)


def extract_img_windows(tokens: torch.Tensor,    # [T] one row's ids
                        hiddens: torch.Tensor,   # [T, D]
                        eoi_token_id: int, num_img_gen_tokens: int,
                        max_imgs: int, boi_token_id: Optional[int] = None):
    """The reference's per-image hidden windows (its static-shape
    ``extract_img_windows``): for each of the first ``max_imgs`` ``</img>``
    at index e, ``hiddens[e - n : e]`` (the start clamped into the row).
    Returns (windows [max_imgs, n, D], valid [max_imgs], text_mask [T]:
    False on the windows, every ``</img>`` and every ``<img>``)."""
    T = hiddens.shape[0]
    n = num_img_gen_tokens
    dev = tokens.device
    is_eoi = tokens == eoi_token_id
    # the EOI positions first, in order, then the others (invalid slots)
    order = torch.argsort((~is_eoi).to(torch.int8), stable=True)[:max_imgs]
    valid = is_eoi[order]
    starts = (order - n).clamp(0, T - 1)
    idx = starts.clamp(max=T - n)[:, None] + torch.arange(n, device=dev)
    windows = hiddens[idx]
    pos = torch.arange(T, device=dev)
    in_window = ((pos[None] >= starts[:, None]) & (pos[None] < order[:, None])
                 & valid[:, None]).any(dim=0)
    text_mask = ~(in_window | is_eoi)
    if boi_token_id is not None:
        text_mask &= tokens != boi_token_id
    return windows, valid, text_mask
