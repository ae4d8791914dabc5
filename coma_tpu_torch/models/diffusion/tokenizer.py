"""CLIP BPE tokenizer (self-contained; reads the standard vocab files).

A copy of ``coma_tpu/models/diffusion/tokenizer.py`` (reference: the
CLIPTokenizer the SD pipeline uses through diffusers): lowercase,
whitespace-collapse, regex split, byte-to-unicode, BPE merges, the ``</w>``
word suffix, BOS/EOS and EOS padding to 77. The vocab (``vocab.json`` and
``merges.txt``, optionally gzipped) ships with every SD checkpoint under
``tokenizer/``.
"""
from __future__ import annotations

import functools
import gzip
import html
import json
import re
from typing import Dict, List, Tuple

MAX_LENGTH = 77


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    def __init__(self, vocab_path: str, merges_path: str):
        with open(vocab_path, "r", encoding="utf-8") as fh:
            self.encoder: Dict[str, int] = json.load(fh)
        self.decoder = {v: k for k, v in self.encoder.items()}
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as fh:
            merges = fh.read().split("\n")
        merges = [tuple(m.split()) for m in merges if m and not m.startswith("#")]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.cache: Dict[str, str] = {}
        # ASCII approximation of CLIP's \p{L}/\p{N} pattern (python re lacks
        # unicode property classes; prompts here are ASCII)
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )
        self.bos = self.encoder.get("<|startoftext|>", 49406)
        self.eos = self.encoder.get("<|endoftext|>", 49407)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        text = whitespace_clean(basic_clean(text)).lower()
        ids: List[int] = []
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def __call__(self, texts, max_length: int = MAX_LENGTH):
        """Tokenize to (B, 77) int32 with BOS/EOS + EOS-padding (CLIP style)."""
        import numpy as np

        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), max_length), self.eos, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.bos] + self.encode_text(text)[: max_length - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return out
