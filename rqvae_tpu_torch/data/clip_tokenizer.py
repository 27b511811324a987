"""CLIP BPE tokenizer (the "simple" tokenizer of the CLIP score).

Port of rqvae_tpu/data/clip_tokenizer.py, pure Python: the byte->unicode
table, lowercase + whitespace-collapse cleaning, regex pre-tokenization,
greedy lowest-rank pair merging over the bpe_simple_vocab_16e6.txt.gz merge
list, with <start_of_text>/<end_of_text> specials, and the HF-tokenizers
surface the CLIP scorer uses (encode().ids, enable_padding /
enable_truncation, token_to_id). `_find` is the JAX package's
rqvae_tpu/data/tokenizers.py lookup: RQVAE_TPU_TOKENIZER_DIR, then this
package's tokenizer_assets directory.
"""

from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from typing import List, Optional

try:  # full unicode word classes when the regex module is present
    import regex as re

    _WORD_PATTERN = (
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
    )
except ImportError:  # ASCII approximation
    import re

    _WORD_PATTERN = (
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+"
    )

_DEFAULT_DIRS = (os.path.join(os.path.dirname(__file__), "tokenizer_assets"),)


def _find(name: str, vocab_dir: Optional[str] = None) -> str:
    """The path of a tokenizer asset: in vocab_dir, then RQVAE_TPU_TOKENIZER_DIR
    (read at the call), then _DEFAULT_DIRS."""
    dirs = [d for d in (vocab_dir, os.environ.get("RQVAE_TPU_TOKENIZER_DIR")) if d] + list(_DEFAULT_DIRS)
    for d in dirs:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"tokenizer asset {name!r} not found in {dirs}; set RQVAE_TPU_TOKENIZER_DIR")


@lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode mapping (GPT-2/CLIP standard)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def clean_text(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text.strip())
    return text.strip().lower()


class _Encoding:
    def __init__(self, ids: List[int]):
        self.ids = ids


class SimpleTokenizer:
    """CLIP BPE over the 16e6 merges file; 49408-token vocab."""

    WORD_RE = re.compile(_WORD_PATTERN, re.IGNORECASE)

    def __init__(self, bpe_path: Optional[str] = None, lowercase: bool = True, **kw):
        bpe_path = bpe_path or _find("bpe_simple_vocab_16e6.txt.gz")
        with gzip.open(bpe_path) as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.pad_length: Optional[int] = None
        self.pad_id = 0
        self.max_length: Optional[int] = None
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    # --- HF-tokenizers-compatible surface -------------------------------
    def add_special_tokens(self, tokens):
        for t in tokens:
            if t not in self.encoder:
                idx = len(self.encoder)
                self.encoder[t] = idx
                self.decoder[idx] = t

    def token_to_id(self, token):
        return self.encoder.get(token)

    def enable_padding(self, length: int, pad_id: int = 0, **kw):
        self.pad_length = length
        self.pad_id = pad_id

    def enable_truncation(self, max_length: int, **kw):
        self.max_length = max_length

    # --- BPE -------------------------------------------------------------
    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def _encode_text(self, text: str) -> List[int]:
        ids = []
        for token in re.findall(self.WORD_RE, clean_text(text)):
            token_b = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token_b).split(" "))
        return ids

    def encode(self, text: str) -> _Encoding:
        ids = [self.sot] + self._encode_text(text) + [self.eot]
        if self.max_length is not None:
            ids = ids[: self.max_length]
        if self.pad_length is not None:
            ids = ids + [self.pad_id] * (self.pad_length - len(ids))
            ids = ids[: self.pad_length]
        return _Encoding(ids)

    def decode(self, ids) -> str:
        text = "".join(
            self.decoder.get(int(i), "") for i in ids
            if int(i) not in (self.sot, self.eot, self.pad_id)
        )
        data = bytearray(self.byte_decoder.get(c, 32) for c in text)
        return data.decode("utf-8", errors="replace").replace("</w>", " ").strip()
