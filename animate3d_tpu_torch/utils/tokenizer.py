"""CLIP BPE tokenizer (self-contained; loads local vocab.json + merges.txt):
the port's own copy of ``animate3d_tpu/utils/tokenizer.py``, which imports
nothing of JAX. Implements the standard CLIP tokenization: NFC-ish
whitespace cleanup, lowercase, the CLIP regex, byte-level encoding with the
GPT-2 byte↔unicode table, BPE merges with the ``</w>`` end-of-word marker,
and <|startoftext|> / <|endoftext|> framing padded to 77 tokens.
"""

from __future__ import annotations

import functools
import json
import os
import re
from typing import Dict, List, Tuple

import numpy as np

_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
    if False else
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
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


def get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class ClipTokenizer:
    def __init__(self, vocab_path: str, merges_path: str, max_length: int = 77):
        self.encoder: Dict[str, int] = json.load(open(vocab_path))
        merges = open(merges_path, encoding="utf-8").read().split("\n")
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        merges = [tuple(m.split()) for m in merges if m and len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.max_length = max_length
        self.bos = self.encoder.get("<|startoftext|>", 0)
        self.eos = self.encoder.get("<|endoftext|>", 0)
        self.cache: Dict[str, str] = {}

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
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
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
        text = re.sub(r"\s+", " ", text.strip()).lower()
        ids: List[int] = []
        for tok in _PAT.findall(text):
            btok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self.bpe(btok).split(" "):
                if piece in self.encoder:
                    ids.append(self.encoder[piece])
        return ids

    def __call__(self, texts, padding: str = "max_length") -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.max_length), self.eos, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos] + self.encode_text(t)[: self.max_length - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return out


def find_tokenizer_files(root: str) -> Tuple[str, str]:
    """Locate vocab.json + merges.txt under a model dir (HF layout)."""
    for sub in ("", "tokenizer"):
        d = os.path.join(root, sub)
        v, m = os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt")
        if os.path.exists(v) and os.path.exists(m):
            return v, m
    raise FileNotFoundError(f"No vocab.json/merges.txt under {root}")


def write_char_level_tokenizer(out_dir: str) -> None:
    """Write a minimal valid vocab.json/merges.txt (byte-level chars + </w>
    forms + specials, no merges). Used for weightless smoke runs and tests;
    real runs read the SD1.5 tokenizer's own files."""
    os.makedirs(out_dir, exist_ok=True)
    chars = list(bytes_to_unicode().values())
    vocab: Dict[str, int] = {}
    for c in chars:
        vocab[c] = len(vocab)
    for c in chars:
        vocab[c + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    with open(os.path.join(out_dir, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(out_dir, "merges.txt"), "w") as f:
        f.write("#version: test\n")
