"""Benchmark CSV loaders (reference C4, `utils/loading.py:151-175`).

The port's own copy of `invertible_cd_tpu/data/benchmarks.py` (pure
Python), so that the port imports nothing of the JAX package.

Two schemas (reference `running/benchmarks/instructions/*.csv`):
  generation: columns (file_name, caption)           -> prompts + names
              (Parti-Prompts uses (id, caption) with no file_name —
              `generation_parti-prompts.csv`; names fall back to
              "<id>.jpg" there)
  editing:    columns (file_name, old_caption,
               edited_caption, blended_words)        -> edit instructions
`blended_words` appears either as "('a', 'b')" tuples (COCO editing) or as
space-separated pairs "a b" (PieBench). A leading unnamed pandas index
column (as in the reference CSVs) is tolerated.
"""
from __future__ import annotations

import ast
import csv
import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class EditInstruction:
    file_name: str
    source_prompt: str
    target_prompt: str
    blend_words: Tuple[str, ...]  # (source_word, target_word) when present


def _parse_blend(raw: str) -> Tuple[str, ...]:
    raw = (raw or "").strip()
    if not raw:
        return ()
    if raw.startswith("("):
        try:
            val = ast.literal_eval(raw)
            if isinstance(val, (tuple, list)):
                return tuple(str(v) for v in val)
        except (ValueError, SyntaxError):
            pass
    return tuple(raw.split())


def load_benchmark(
    path: str, kind: Optional[str] = None, max_count: Optional[int] = None,
    with_files: bool = False,
):
    """Load a benchmark CSV.

    kind: "generation" | "editing" | None (sniffed from the header).
    Returns list[str] prompts (generation; `(file_name, caption)` pairs
    instead when `with_files` — the invert/reconstruct mode needs the real
    image paths, reference `generate.py` path_to_images) or
    list[EditInstruction] (editing), truncated to max_count (the
    reference's --max_cnt).
    """
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
    if not rows:
        return []
    header = rows[0].keys()
    if kind is None:
        kind = "editing" if "edited_caption" in header else "generation"

    if kind == "generation":
        if with_files:
            # Parti's schema has ids instead of file names -> "<id>.jpg";
            # a row with NEITHER a file_name nor an id is skipped (never
            # fabricate a name — reconstruct mode would try to open it).
            out: List = []
            for r in rows:
                if not r.get("caption"):
                    continue
                name = r.get("file_name")
                if not name and r.get("id") not in (None, ""):
                    name = f"{r['id']}.jpg"
                if name:
                    out.append((name, r["caption"]))
        else:
            out = [r["caption"] for r in rows if r.get("caption")]
    else:
        out = [
            EditInstruction(
                file_name=r["file_name"],
                source_prompt=r["old_caption"],
                target_prompt=r["edited_caption"],
                blend_words=_parse_blend(r.get("blended_words", "")),
            )
            for r in rows
        ]
    if max_count is not None:
        out = out[:max_count]
    return out
