"""CLIP byte-level BPE tokenizer (the port's own copy of
aphantasia_tpu.models.clip.tokenizer).

Implements the same tokenization contract as OpenAI's `clip.tokenize`
(used by the reference at clip_fft.py:150, illustrip.py:191): lowercased,
whitespace-cleaned text -> byte-level BPE ids framed by <|startoftext|> /
<|endoftext|>, padded to context length 77.

The BPE merges table (`bpe_simple_vocab_16e6.txt.gz`) is not redistributable
inside this repo; it is discovered at runtime from $APHANTASIA_BPE_PATH or an
installed `clip` package.  Without it, a deterministic hash fallback maps
whole words into the BPE id space — the pipeline stays runnable and
shape-identical (embeddings are only meaningful with real merges + weights).
"""
from __future__ import annotations

import functools
import gzip
import hashlib
import html
import os

VOCAB_SIZE = 49408
SOT = 49406  # <|startoftext|>
EOT = 49407  # <|endoftext|>
CONTEXT = 77


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> printable-unicode map (GPT-2 convention)."""
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


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def whitespace_clean(text: str) -> str:
    import re
    return re.sub(r"\s+", " ", text).strip()


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _find_bpe_vocab():
    cand = [os.environ.get("APHANTASIA_BPE_PATH")]
    try:
        import clip as _clip  # upstream package, if installed
        cand.append(os.path.join(os.path.dirname(_clip.__file__),
                                 "bpe_simple_vocab_16e6.txt.gz"))
    except ImportError:
        pass
    cand.append(os.path.join(os.path.dirname(__file__),
                             "bpe_simple_vocab_16e6.txt.gz"))
    for p in cand:
        if p and os.path.isfile(p):
            return p
    return None


class SimpleTokenizer:
    """Full byte-level BPE when a merges file is available."""

    def __init__(self, bpe_path: str):
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        import regex
        self.pat = regex.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", regex.IGNORECASE)

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

    def encode(self, text: str):
        bpe_tokens = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens


class HashTokenizer:
    """Deterministic fallback: whole words -> stable ids in the BPE id space.

    Keeps tokenization shape-compatible (and runs hermetically); NOT
    vocabulary-compatible with real CLIP weights.
    """

    def encode(self, text: str):
        text = whitespace_clean(basic_clean(text)).lower()
        ids = []
        for word in text.split(" "):
            if not word:
                continue
            h = int(hashlib.sha256(word.encode()).hexdigest(), 16)
            ids.append(h % (SOT - 1) + 1)  # avoid 0 and special ids
        return ids


@functools.lru_cache()
def _tokenizer():
    path = _find_bpe_vocab()
    if path is not None:
        return SimpleTokenizer(path)
    from aphantasia_torch.weights import warn_random
    warn_random("clip tokenizer (BPE vocab missing — hash fallback, NOT "
                "vocabulary-compatible with real CLIP weights)")
    return HashTokenizer()


def tokenize(texts, context_length: int = CONTEXT, truncate: bool = True):
    """texts -> int32 array [N, context_length], matching clip.tokenize."""
    import numpy as np
    if isinstance(texts, str):
        texts = [texts]
    tok = _tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [SOT] + tok.encode(text) + [EOT]
        if len(ids) > context_length:
            if truncate:
                ids = ids[:context_length]
                ids[-1] = EOT
            else:
                raise RuntimeError(f"Input too long for context {context_length}")
        result[i, :len(ids)] = ids
    return result
