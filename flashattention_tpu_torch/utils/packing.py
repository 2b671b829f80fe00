"""Document packing for segment-ids training.

The port's own copy of ``flashattention_tpu/utils/packing.py`` (pure numpy;
the port imports nothing of the JAX package).  Turns variable-length
tokenized documents into fixed-shape (tokens, segment_ids) rows for
:func:`models.train.make_train_step_packed`: attention stays within
documents (kernel segment masking), RoPE restarts per document, and the
loss masks padding and document boundaries.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pack_documents", "PAD_SEGMENT"]

PAD_SEGMENT = -1  # segment id marking padding (negative = invalid target)


def pack_documents(
    docs,
    row_len: int,
    *,
    pad_token: int = 0,
    truncate: bool = False,
):
    """Greedy first-fit packing of token lists into (N, row_len) rows.

    Args:
      docs: iterable of token sequences (lists / 1-D arrays of ints).
      row_len: row length (any length: the CUDA kernels mask the ragged
        edge).
      pad_token: token id written into padding positions (never a target:
        their segment id is :data:`PAD_SEGMENT`).
      truncate: documents longer than ``row_len`` are truncated when True,
        rejected with ValueError when False (splitting a document across
        rows would sever its attention context — never done silently).

    Returns:
      (tokens, segment_ids): two int32 arrays of shape (num_rows, row_len).
      Segment ids are unique per document WITHIN a row (0, 1, 2, ...) —
      exactly what the kernel's same-segment mask needs — and padding is
      PAD_SEGMENT.

    First-fit keeps arrival order cheap to reason about while filling rows
    well for typical length mixes; rows are closed only when no remaining
    document fits.
    """
    if row_len < 1:
        raise ValueError(f"row_len must be >= 1 (got {row_len})")
    rows: list[list[list[int]]] = []  # each row: list of docs
    space: list[int] = []  # free tokens per open row
    for i, doc in enumerate(docs):
        toks = list(map(int, doc))
        if not toks:
            continue
        if len(toks) > row_len:
            if not truncate:
                raise ValueError(
                    f"document {i} has {len(toks)} tokens > row_len "
                    f"{row_len}; pass truncate=True to clip"
                )
            toks = toks[:row_len]
        for r in range(len(rows)):  # first fit
            if space[r] >= len(toks):
                rows[r].append(toks)
                space[r] -= len(toks)
                break
        else:
            rows.append([toks])
            space.append(row_len - len(toks))
    n = len(rows)
    tokens = np.full((n, row_len), pad_token, np.int32)
    segments = np.full((n, row_len), PAD_SEGMENT, np.int32)
    for r, row_docs in enumerate(rows):
        at = 0
        for seg, toks in enumerate(row_docs):
            tokens[r, at : at + len(toks)] = toks
            segments[r, at : at + len(toks)] = seg
            at += len(toks)
    return tokens, segments
