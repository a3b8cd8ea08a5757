"""Data pipeline: byte-level tokenizer + synthetic corpora + batchers
(a copy of ``repro/data/pipeline.py``: numpy only, so the same seeds give
the same corpus and batches bit for bit).

Self-contained (no external datasets): a seeded
Markov/Zipf synthetic corpus provides learnable structure for the training
examples, and a byte tokenizer handles real text in the quickstart.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterator, Optional

import numpy as np


class ByteTokenizer:
    """Trivial reversible byte-level tokenizer (vocab 256 + specials)."""
    PAD, BOS, EOS = 256, 257, 258
    vocab_size = 259

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), dtype=np.uint8
                             ).astype(np.int32)

    def decode(self, ids) -> str:
        ids = [int(i) for i in ids if int(i) < 256]
        return bytes(ids).decode("utf-8", errors="replace")


def synthetic_corpus(vocab_size: int, length: int, *, seed: int = 0,
                     order: int = 2, zipf_a: float = 1.3) -> np.ndarray:
    """Markov chain over a Zipf-distributed vocabulary — has enough local
    structure that a small LM visibly reduces loss within ~100 steps."""
    rng = np.random.default_rng(seed)
    V = vocab_size
    base = rng.zipf(zipf_a, size=length * 2) % V
    out = np.empty(length, np.int32)
    # deterministic per-context successor tables (sparse markov structure)
    mix = rng.integers(0, V, size=(257,), dtype=np.int64)
    out[:order] = base[:order]
    for i in range(order, length):
        ctx = (out[i - 1] * 31 + out[i - 2] * 17) % 257
        if rng.random() < 0.75:
            out[i] = (mix[ctx] + out[i - 1]) % V
        else:
            out[i] = base[i]
    return out


def lm_batches(corpus: np.ndarray, batch: int, seq_len: int, *,
               seed: int = 0, extras: Optional[Dict] = None
               ) -> Iterator[Dict]:
    """Endless (tokens, labels) batches for next-token prediction."""
    rng = np.random.default_rng(seed)
    n = len(corpus) - seq_len - 1
    while True:
        idx = rng.integers(0, n, size=batch)
        toks = np.stack([corpus[i:i + seq_len] for i in idx])
        labs = np.stack([corpus[i + 1:i + seq_len + 1] for i in idx])
        b = {"tokens": toks.astype(np.int32), "labels": labs.astype(np.int32)}
        if extras:
            b.update(extras)
        yield b


def take(it: Iterator, n: int):
    return itertools.islice(it, n)
