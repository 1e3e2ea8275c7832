"""Deterministic offline tokenizer (the port's copy of
``mllm_npu_tpu/utils/fake_tokenizer.py``; ids must stay identical so the
two packages decode the same prompts to the same ids)."""

from __future__ import annotations

import re
import zlib

from mllm_npu_tpu_torch.constant import (BOI_TOKEN, BOP_TOKEN, EOI_TOKEN,
                                         EOP_TOKEN, IMG_TOKEN)


class FakeTokenizer:
    """Special tokens (incl. the <img_xxxxx> ladder and <patch> spans) map
    to single dedicated ids; words hash into the remaining vocab."""

    def __init__(self, vocab_size: int = 4096, num_img_tokens: int = 100):
        self.vocab_size = vocab_size
        self.bos_token_id, self.eos_token_id, self.pad_token_id = 1, 2, 0
        self.special = {"<s>": 1, "</s>": 2, "<unk>": 0,
                        BOI_TOKEN: 10, EOI_TOKEN: 11,
                        BOP_TOKEN: 12, EOP_TOKEN: 13}
        for i in range(num_img_tokens):
            self.special[IMG_TOKEN.format(i)] = 20 + i
        self._rev = {v: k for k, v in self.special.items()}
        self._pattern = re.compile(
            "(" + "|".join(re.escape(t) for t in sorted(
                self.special, key=len, reverse=True)) + ")")
        self._word_base = 20 + num_img_tokens

    def encode(self, text: str, add_special_tokens: bool = False):
        ids = []
        for part in self._pattern.split(text):
            if not part:
                continue
            if part in self.special:
                ids.append(self.special[part])
            else:
                for w in part.split():
                    # crc32, not hash(): stable across processes
                    h = (zlib.crc32(w.encode("utf-8"))
                         % (self.vocab_size - self._word_base))
                    ids.append(self._word_base + h)
        return ids

    def decode(self, ids, skip_special_tokens=False):
        toks = []
        for i in list(ids):
            i = int(i)
            if i in self._rev:
                if not skip_special_tokens:
                    toks.append(self._rev[i])
            else:
                toks.append(f"w{i}")
        return " ".join(toks)
