"""Prompt-prefix KV cache for the continuous-batching engine (twin of
``mllm_npu_tpu/serve/prefix_cache.py``).

Entries are keyed by the exact token prefix they cover and hold the
per-request prefill KV ``[L, 1, plen, Hkv, D]`` cut at a *granularity*
boundary (the engine's prompt bucket). Causal attention makes the cut
exact: the key and value at position ``i`` depend only on tokens
``<= i``. A lookup is the longest aligned match over the store (a linear
scan of a small host-side store), capped so at least one real token is
left to prefill (its logits give the first token). Admission seeds the
engine's chunked-prefill loop with the cached blocks and starts it at the
cached length. Eviction is LRU by entry count. Text-only: requests with
images neither hit nor fill the store (image KV depends on pixels, not
only on token ids).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class PrefixEntry:
    tokens: Tuple[int, ...]      # the exact prefix covered
    k: torch.Tensor              # [L, 1, plen, Hkv, D]
    v: torch.Tensor
    tick: int = 0                # LRU stamp


class PrefixCache:
    """LRU store of prompt-prefix KV blocks on the device. ``granularity``
    aligns what is stored and served; the engine passes its prompt bucket
    so a hit always lands on a chunk boundary of the chunked prefill."""

    def __init__(self, max_entries: int, granularity: int):
        if max_entries <= 0 or granularity <= 0:
            raise ValueError("max_entries and granularity must be positive")
        self.max_entries = max_entries
        self.granularity = granularity
        self._store: Dict[Tuple[int, ...], PrefixEntry] = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0

    def __len__(self) -> int:
        return len(self._store)

    def lookup(self, prompt: np.ndarray, *,
               align: Optional[int] = None) -> Optional[PrefixEntry]:
        """Longest cached prefix of ``prompt``, cut to ``align`` (default
        the granularity) and to at most ``len(prompt) - 1`` tokens, or None
        when no usable prefix is cached."""
        g = self.granularity if align is None else align
        usable = ((int(prompt.shape[0]) - 1) // g) * g
        if usable <= 0:
            self.misses += 1
            return None
        best: Optional[PrefixEntry] = None
        best_len = 0
        ptup = tuple(int(t) for t in prompt[:usable])
        for toks, entry in self._store.items():
            bound = min(len(toks), usable)
            common = 0
            for a, b in zip(toks[:bound], ptup[:bound]):
                if a != b:
                    break
                common += 1
            n = (common // g) * g
            if n > best_len:
                best, best_len = entry, n
        if best is None:
            self.misses += 1
            return None
        self._tick += 1
        best.tick = self._tick
        self.hits += 1
        self.tokens_saved += best_len
        if best_len == len(best.tokens):
            return best
        # the entry cut to the matched aligned length (a causal KV slice)
        return PrefixEntry(best.tokens[:best_len], best.k[:, :, :best_len],
                           best.v[:, :, :best_len], best.tick)

    def insert(self, prompt: np.ndarray, k: torch.Tensor,
               v: torch.Tensor) -> None:
        """Store the longest granularity-aligned prefix of ``prompt`` from
        its fresh prefill KV ``[L, 1, bucket, Hkv, D]`` (copied, so the
        prefill's cache can be freed). No-op if that prefix is empty or
        already stored."""
        g = self.granularity
        cut = (int(prompt.shape[0]) // g) * g
        if cut <= 0:
            return
        key = tuple(int(t) for t in prompt[:cut])
        self._tick += 1
        existing = self._store.get(key)
        if existing is not None:
            existing.tick = self._tick
            return
        self._store[key] = PrefixEntry(key, k[:, :, :cut].clone(),
                                       v[:, :, :cut].clone(), self._tick)
        while len(self._store) > self.max_entries:
            lru = min(self._store.values(), key=lambda e: e.tick)
            del self._store[lru.tokens]

    def stats(self) -> dict:
        return {"entries": len(self._store), "hits": self.hits,
                "misses": self.misses, "tokens_saved": self.tokens_saved}
