"""CLIP byte-pair-encoding tokenizer, pure Python (port of
models/tokenizer.py; open_clip's SimpleTokenizer).

The BPE merge table is the public `bpe_simple_vocab_16e6.txt.gz` asset the
repository vendors under `online_lang_splatting_tpu/assets/`; it is read
by path (the port never imports the JAX package). `OLS_TPU_BPE_PATH` or
`vocab_path` override it.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from pathlib import Path

import numpy as np

CONTEXT_LENGTH = 77

_ASSET = (Path(__file__).resolve().parents[2] / "online_lang_splatting_tpu"
          / "assets" / "bpe_simple_vocab_16e6.txt.gz")


def find_vocab() -> str | None:
    for p in (os.environ.get("OLS_TPU_BPE_PATH", ""), str(_ASSET)):
        if p and os.path.exists(p):
            return p
    return None


@functools.lru_cache()
def _bytes_to_unicode():
    """GPT-2 byte -> printable unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


class SimpleTokenizer:
    def __init__(self, vocab_path: str | None = None):
        vocab_path = vocab_path or find_vocab()
        if vocab_path is None:
            raise FileNotFoundError(
                "CLIP BPE vocab not found; set OLS_TPU_BPE_PATH to a "
                "bpe_simple_vocab_16e6.txt.gz")
        self.byte_encoder = _bytes_to_unicode()
        with gzip.open(vocab_path) as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in merges[1: 49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<start_of_text>", "<end_of_text>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<start_of_text>": "<start_of_text>",
                      "<end_of_text>": "<end_of_text>"}
        # ASCII classes in place of \p{L} / \p{N} (which need the `regex`
        # module); equivalent for English queries.
        self.pat = re.compile(
            r"<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE)
        self.sot = self.encoder["<start_of_text>"]
        self.eot = self.encoder["<end_of_text>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for token in re.findall(self.pat, _clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def __call__(self, texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), np.int64)
        for i, text in enumerate(texts):
            tokens = [self.sot] + self.encode(text) + [self.eot]
            if len(tokens) > context_length:
                tokens = tokens[:context_length]
                tokens[-1] = self.eot
            result[i, : len(tokens)] = tokens
        return result
