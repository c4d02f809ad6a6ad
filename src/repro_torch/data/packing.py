"""Sequence packing for LM training (port of ``repro.data.packing``).

Concatenates variable-length documents into fixed-length training rows
separated by an EOS token, with a segment-id array so the loss can mask
cross-document positions.  Greedy first-fit packing -- the standard
throughput lever for long-tail document lengths.  Numpy only, as in the
reference; the rows feed ``make_train_step`` as ``{"tokens": ...}``.
"""
from __future__ import annotations

import numpy as np


def pack_documents(docs, seq_len: int, *, eos_id: int, pad_id: int = 0):
    """docs: list of 1-D int arrays.  Returns (tokens, segment_ids) of
    shape (n_rows, seq_len); segment 0 = padding.  A document longer
    than the room left in a row continues in the next row under the
    next row's segment numbering; its EOS follows its last token where
    the row has room for it."""
    rows, segs = [], []
    cur = np.full((seq_len,), pad_id, np.int32)
    cur_seg = np.zeros((seq_len,), np.int32)
    off, seg = 0, 1

    def flush():
        nonlocal cur, cur_seg, off, seg
        rows.append(cur)
        segs.append(cur_seg)
        cur = np.full((seq_len,), pad_id, np.int32)
        cur_seg = np.zeros((seq_len,), np.int32)
        off, seg = 0, 1

    for doc in docs:
        doc = np.asarray(doc, np.int32)
        need = len(doc) + 1                     # + EOS
        while need > 0:
            space = seq_len - off
            if space == 0:
                flush()
                continue
            take = min(space, len(doc))
            cur[off:off + take] = doc[:take]
            cur_seg[off:off + take] = seg
            off += take
            doc = doc[take:]
            need = len(doc) + 1
            if len(doc) == 0:
                if off < seq_len:
                    cur[off] = eos_id
                    cur_seg[off] = seg
                    off += 1
                seg += 1
                need = 0
    if off > 0:
        flush()
    return np.stack(rows), np.stack(segs)


def packing_labels(tokens, segment_ids, *, ignore=-1):
    """Next-token labels that never cross a document boundary: a
    position whose successor lies in another segment (or in padding)
    gets ``ignore``."""
    labels = np.concatenate(
        [tokens[:, 1:], np.full_like(tokens[:, :1], ignore)], axis=1)
    seg_next = np.concatenate(
        [segment_ids[:, 1:], np.zeros_like(segment_ids[:, :1])], axis=1)
    cross = (seg_next != segment_ids) | (seg_next == 0)
    return np.where(cross, ignore, labels)
