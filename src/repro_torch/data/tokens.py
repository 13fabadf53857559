"""Synthetic LM token pipeline for the transformer substrate (the port's
copy of ``repro/data/tokens.py``: numpy only, so both packages draw the
same batches bit for bit from one seed).

Deterministic Zipf-distributed token streams with next-token structure
(bigram mixing) so train steps have a learnable signal; host-sharded
loading mirrors how each data-parallel worker would read its own files.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab_size: int, seed: int = 0, zipf_a: float = 1.2):
        self.vocab_size = vocab_size
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** -zipf_a
        self.p = p / p.sum()
        # a fixed random bigram successor table gives next-token signal
        self.successor = self.rng.integers(0, vocab_size, size=vocab_size)

    def batch(self, batch_size: int, seq_len: int) -> dict:
        base = self.rng.choice(self.vocab_size, size=(batch_size, seq_len),
                               p=self.p)
        # with prob 0.5 each token is the deterministic successor of the
        # previous one -> learnable bigram structure
        follow = self.rng.random((batch_size, seq_len)) < 0.5
        toks = base.copy()
        toks[:, 1:] = np.where(follow[:, 1:],
                               self.successor[toks[:, :-1]], base[:, 1:])
        tokens = toks[:, :-1] if seq_len > 1 else toks
        labels = toks[:, 1:] if seq_len > 1 else toks
        return {"tokens": tokens.astype(np.int32),
                "labels": labels.astype(np.int32)}


def host_sharded_stream(vocab_size: int, num_hosts: int, host_id: int,
                        seed: int = 0) -> TokenStream:
    """Each host reads a disjoint stream (data parallel input pipeline)."""
    return TokenStream(vocab_size, seed=seed * num_hosts + host_id)
