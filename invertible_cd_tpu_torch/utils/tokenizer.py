"""CLIP byte-pair-encoding tokenizer (self-contained, no `tokenizers` dep).

A copy of `invertible_cd_tpu/utils/tokenizer.py` (the CLIP and hash
tokenizers; the BERT tokenizer stays with the metrics), kept here so the
PyTorch package imports nothing of the JAX package. It loads the standard
CLIP `vocab.json` + `merges.txt` artifacts when available, plus a
deterministic `HashTokenizer` used by tests and dry runs when no vocab
files are present.

Encoding contract (what the SD text encoders expect):
  * lowercase, collapse whitespace, HTML-unescape;
  * BPE over byte-level unicode with `</w>` end-of-word markers;
  * sequences are `<|startoftext|> ... <|endoftext|>` padded with the
    end token (CLIP-L pads with eot; SDXL's OpenCLIP pads with 0 — the
    `pad_token_id` knob covers both) to `context_length` (77).
"""
from __future__ import annotations

import functools
import gzip
import html
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import regex as _re

    _PAT = _re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _re.IGNORECASE,
    )
except ImportError:  # pragma: no cover - the `regex` package is optional
    import re as _re

    _PAT = _re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
        _re.IGNORECASE,
    )


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (standard byte-level BPE)."""
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
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return " ".join(text.split())


class ClipTokenizer:
    """BPE tokenizer compatible with CLIP vocab artifacts.

    Args:
      vocab: token -> id map (49408 entries for CLIP).
      merges: list of merge pairs in priority order.
      pad_token_id: id used for padding (None -> eot, CLIP-L convention;
        0 for SDXL's second encoder).
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        context_length: int = 77,
        pad_token_id: Optional[int] = None,
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.context_length = context_length
        self.bos_token_id = self.encoder["<|startoftext|>"]
        self.eos_token_id = self.encoder["<|endoftext|>"]
        self.pad_token_id = self.eos_token_id if pad_token_id is None else pad_token_id
        self._cache: Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    # -- construction helpers ------------------------------------------------
    @staticmethod
    def from_files(
        vocab_path: str, merges_path: str, **kw
    ) -> "ClipTokenizer":
        with open(vocab_path, "r", encoding="utf-8") as f:
            vocab = json.load(f)
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [
            tuple(line.split()) for line in lines
            if line and not line.startswith("#version") and len(line.split()) == 2
        ]
        return ClipTokenizer(vocab, merges, **kw)

    @staticmethod
    def find(root: Optional[str] = None, **kw) -> Optional["ClipTokenizer"]:
        """Locate vocab artifacts via ICD_TPU_CLIP_VOCAB[_MERGES] env vars or
        a directory containing vocab.json + merges.txt."""
        vocab = os.environ.get("ICD_TPU_CLIP_VOCAB")
        merges = os.environ.get("ICD_TPU_CLIP_MERGES")
        if vocab and merges and os.path.exists(vocab):
            return ClipTokenizer.from_files(vocab, merges, **kw)
        for base in filter(None, [root, os.environ.get("ICD_TPU_ASSETS")]):
            v = os.path.join(base, "vocab.json")
            m = os.path.join(base, "merges.txt")
            if os.path.exists(v) and os.path.exists(m):
                return ClipTokenizer.from_files(v, m, **kw)
        return None

    # -- BPE core ------------------------------------------------------------
    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
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
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[int]:
        """Raw BPE ids, no special tokens."""
        text = whitespace_clean(basic_clean(text)).lower()
        ids: List[int] = []
        for tok in _PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def __call__(self, texts, truncate: bool = True) -> np.ndarray:
        """Encode to a padded (B, context_length) int32 array."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.full(
            (len(texts), self.context_length), self.pad_token_id, np.int32
        )
        for i, text in enumerate(texts):
            ids = [self.bos_token_id] + self.tokenize(text) + [self.eos_token_id]
            if len(ids) > self.context_length:
                if not truncate:
                    raise ValueError(f"Prompt too long: {text!r}")
                ids = ids[: self.context_length]
                ids[-1] = self.eos_token_id
            result[i, : len(ids)] = ids
        return result

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(
            self.decoder.get(int(i), "") for i in ids
            if int(i) not in (self.bos_token_id, self.eos_token_id, self.pad_token_id)
        )
        raw = bytearray(self.byte_decoder.get(c, 32) for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)


class HashTokenizer:
    """Deterministic stand-in tokenizer for tests / vocab-free environments.

    Maps each whitespace word to a stable id via FNV-1a hashing. Same
    surface as ClipTokenizer (`__call__`, bos/eos/pad ids, context_length)
    so pipelines and controllers exercise identical code paths.
    """

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.bos_token_id = vocab_size - 2
        self.eos_token_id = vocab_size - 1
        self.pad_token_id = self.eos_token_id

    def tokenize(self, text: str) -> List[int]:
        words = whitespace_clean(basic_clean(text)).lower().split(" ")
        ids = []
        for w in words:
            if not w:
                continue
            h = 2166136261
            for ch in w.encode("utf-8"):
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            ids.append(h % (self.vocab_size - 2))
        return ids

    def __call__(self, texts, truncate: bool = True) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.context_length), self.pad_token_id, np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos_token_id] + self.tokenize(t) + [self.eos_token_id]
            ids = ids[: self.context_length]
            ids[-1] = self.eos_token_id
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids) -> str:  # irreversible by construction
        return " ".join(f"<{int(i)}>" for i in ids)


def default_tokenizer(**kw):
    """ClipTokenizer if vocab artifacts are discoverable, else HashTokenizer
    (which ignores ClipTokenizer-only kwargs like pad_token_id)."""
    tok = ClipTokenizer.find(**kw)
    return tok if tok is not None else HashTokenizer()
