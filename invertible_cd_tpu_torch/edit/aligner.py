"""Prompt token alignment for prompt-to-prompt editing (host-side numpy).

A copy of `invertible_cd_tpu/edit/aligner.py`, kept here so the PyTorch
package imports nothing of the JAX package. Given a source/target prompt
pair it produces the token mappers that the attention controllers
(`edit/controllers.py`) consume:

  * refinement: Needleman-Wunsch global alignment of the two token
    sequences -> per-target-token source index + "is aligned" alpha
    (`get_mapper`, JAX `aligner.py:86`);
  * replacement: a 77x77 soft permutation matrix for equal-word-count
    prompts (`get_replacement_mapper_`, JAX `aligner.py:145`);
  * word -> token-index lookup used by LocalBlend and the equalizers
    (`get_word_inds`, JAX `aligner.py:127`).

It reads only the tokenizer's `tokenize`, `bos_token_id` and
`eos_token_id` (`utils/tokenizer.py`). The traceback prefers left > up >
diag on equal scores; `word_token_spans` tokenizes word by word (CLIP BPE
is whitespace-delimited, so this is exact).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

MAX_NUM_WORDS = 77


def needleman_wunsch(
    x: Sequence[int], y: Sequence[int], gap: int = 0, match: int = 1, mismatch: int = -1
) -> List[Tuple[int, int]]:
    """Global alignment; returns (y_index, x_index) pairs in y order with
    x_index == -1 where y[j] is an insertion (no aligned source token)."""
    nx, ny = len(x), len(y)
    score = np.zeros((nx + 1, ny + 1), np.int32)
    score[0, 1:] = (np.arange(ny) + 1) * gap
    score[1:, 0] = (np.arange(nx) + 1) * gap
    # traceback codes: 1 = left (y insertion), 2 = up (x deletion), 3 = diag
    trace = np.zeros((nx + 1, ny + 1), np.int8)
    trace[0, 1:] = 1
    trace[1:, 0] = 2
    for i in range(1, nx + 1):
        for j in range(1, ny + 1):
            left = score[i, j - 1] + gap
            up = score[i - 1, j] + gap
            diag = score[i - 1, j - 1] + (match if x[i - 1] == y[j - 1] else mismatch)
            best = max(left, up, diag)
            score[i, j] = best
            trace[i, j] = 1 if best == left else (2 if best == up else 3)

    pairs: List[Tuple[int, int]] = []
    i, j = nx, ny
    while i > 0 or j > 0:
        code = trace[i, j]
        if code == 3:
            i -= 1
            j -= 1
            pairs.append((j, i))
        elif code == 1:
            j -= 1
            pairs.append((j, -1))
        else:
            i -= 1
    pairs.reverse()
    return pairs


def _encode(tokenizer, text: str, max_len: int = MAX_NUM_WORDS) -> List[int]:
    """Token ids including bos/eos, truncated to the context length
    (alignment runs over the full sequence, matching the reference's use of
    HF `encode`; the reference crashes on >77-token prompts — we truncate
    like the encoding path does)."""
    ids = [tokenizer.bos_token_id] + tokenizer.tokenize(text) + [tokenizer.eos_token_id]
    if len(ids) > max_len:
        ids = ids[:max_len]
        ids[-1] = tokenizer.eos_token_id
    return ids


def get_mapper(
    x: str, y: str, tokenizer, max_len: int = MAX_NUM_WORDS
) -> Tuple[np.ndarray, np.ndarray]:
    """Refinement mapper for one (source, target) pair.

    Returns:
      mapper: (max_len,) int64 — source token index for each target token
        position (insertions point at -1; the tail continues past the target
        length so gathered values stay in range).
      alphas: (max_len,) float32 — 0 where the target token is an insertion
        (new token: keep the edited prompt's own attention), 1 elsewhere.
    """
    xs, ys = _encode(tokenizer, x), _encode(tokenizer, y)
    pairs = np.asarray(needleman_wunsch(xs, ys), np.int64)
    alphas = np.ones((max_len,), np.float32)
    alphas[: len(pairs)] = (pairs[:, 1] != -1).astype(np.float32)
    mapper = np.zeros((max_len,), np.int64)
    mapper[: len(pairs)] = pairs[:, 1]
    mapper[len(pairs):] = len(ys) + np.arange(max_len - len(ys))
    return mapper, alphas


def get_refinement_mapper(
    prompts: Sequence[str], tokenizer, max_len: int = MAX_NUM_WORDS
) -> Tuple[np.ndarray, np.ndarray]:
    """(B-1, 77) mappers + alphas, prompts[0] is the source."""
    out = [get_mapper(prompts[0], p, tokenizer, max_len) for p in prompts[1:]]
    return np.stack([m for m, _ in out]), np.stack([a for _, a in out])


def word_token_spans(text: str, tokenizer) -> List[Tuple[int, int]]:
    """[start, end) token positions of each whitespace word (bos at pos 0)."""
    spans = []
    pos = 1  # skip bos
    for word in text.split(" "):
        n = len(tokenizer.tokenize(word)) if word else 0
        spans.append((pos, pos + n))
        pos += n
    return spans


def get_word_inds(
    text: str, word_place: Union[int, str], tokenizer
) -> np.ndarray:
    """Token indices of a word (by position or by string match) — used to
    build LocalBlend masks and equalizers (reference `seq_aligner.py:117-137`)."""
    words = text.split(" ")
    if isinstance(word_place, str):
        places = [i for i, w in enumerate(words) if w == word_place]
    else:
        places = [word_place]
    spans = word_token_spans(text, tokenizer)
    out: List[int] = []
    for p in places:
        if 0 <= p < len(spans):
            out.extend(range(spans[p][0], spans[p][1]))
    return np.asarray(out, np.int64)


def get_replacement_mapper_(
    x: str, y: str, tokenizer, max_len: int = MAX_NUM_WORDS
) -> np.ndarray:
    """77x77 soft permutation for word-level replacement between equal-length
    prompts; replaced words may expand/contract in token count (weights split
    uniformly across target tokens, reference `seq_aligner.py:139-168`)."""
    wx, wy = x.split(" "), y.split(" ")
    if len(wx) != len(wy):
        raise ValueError(
            "replacement mapper needs equal word counts: "
            f"{len(wx)} vs {len(wy)} — use the refinement controller instead"
        )
    sx, sy = word_token_spans(x, tokenizer), word_token_spans(y, tokenizer)
    changed = [w for w in range(len(wx)) if wx[w] != wy[w]]
    blocks = [
        (np.arange(*sx[w]), np.arange(*sy[w])) for w in changed
    ]  # (source token inds, target token inds) per replaced word

    mapper = np.zeros((max_len, max_len), np.float32)
    i = j = 0
    r = 0
    while i < max_len and j < max_len:
        if r < len(blocks) and len(blocks[r][0]) and blocks[r][0][0] == i:
            src, tgt = blocks[r]
            if len(src) == len(tgt):
                mapper[src[src < max_len], tgt[src < max_len]] = 1.0
            else:
                ratio = 1.0 / len(tgt)
                for jj in tgt[tgt < max_len]:
                    mapper[src[src < max_len], jj] = ratio
            i += len(src)
            j += len(tgt)
            r += 1
        elif r < len(blocks):
            mapper[i, j] = 1.0
            i += 1
            j += 1
        else:
            # Past the last replaced word the walk pins the true diagonal
            # (reference `seq_aligner.py:162-165`).
            mapper[j, j] = 1.0
            i += 1
            j += 1
    return mapper


def get_replacement_mapper(
    prompts: Sequence[str], tokenizer, max_len: int = MAX_NUM_WORDS
) -> np.ndarray:
    return np.stack(
        [get_replacement_mapper_(prompts[0], p, tokenizer, max_len) for p in prompts[1:]]
    )
