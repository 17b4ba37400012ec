"""Deterministic synthetic LM data (port of ``repro.data.synthetic``).

``make_markov_table`` is the reference's numpy construction, bit for bit:
each token has ``branching`` likely successors with logits ~ N(2, 0.5),
every other successor -4.  A dense [V, V] table does not fit at a full
vocabulary (122,753^2 f32 is 60 GB), so the sampler works on the same
chain kept sparse (:class:`MarkovChain`: the successors and their logits;
``dense()`` rebuilds the table), and draws each next token from
softmax(table[tok]) exactly: a successor or the background bucket by
their total weights, then a uniform non-successor within the bucket.

``lm_batch`` draws from an explicit ``torch.Generator``; JAX's random
stream cannot be reproduced, so parity tests feed JAX batches as numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device

_BACKGROUND = -4.0


@dataclasses.dataclass(frozen=True)
class MarkovChain:
    succ: np.ndarray        # [V, branching] int64, distinct per row
    logits: np.ndarray      # [V, branching] f32

    @property
    def vocab(self) -> int:
        return self.succ.shape[0]

    def dense(self) -> np.ndarray:
        """The [V, V] f32 logits table."""
        table = np.full((self.vocab, self.vocab), _BACKGROUND, np.float32)
        np.put_along_axis(table, self.succ, self.logits, axis=1)
        return table


def markov_chain(seed: int, vocab: int, branching: int = 4) -> MarkovChain:
    """The reference's random draws, row by row, kept sparse."""
    rng = np.random.default_rng(seed)
    succ = np.empty((vocab, branching), np.int64)
    logits = np.empty((vocab, branching), np.float32)
    for v in range(vocab):
        succ[v] = rng.choice(vocab, size=branching, replace=False)
        logits[v] = rng.normal(2.0, 0.5, branching)
    return MarkovChain(succ, logits)


def make_markov_table(seed: int, vocab: int, branching: int = 4
                      ) -> np.ndarray:
    """Each token has ``branching`` likely successors; [V, V] logits."""
    return markov_chain(seed, vocab, branching).dense()


def lm_batch(chain: MarkovChain, gen: torch.Generator, batch: int, seq: int,
             device=None):
    """Markov stream: tokens[t+1] ~ softmax(table[tokens[t]]).  Returns
    {"tokens", "labels"} [batch, seq] int64 on ``device``; draws on the
    CPU from ``gen``."""
    dev = resolve_device(device)
    v, nb = chain.succ.shape
    succ = torch.from_numpy(chain.succ)
    # bucket weights: the successors, then all V - nb others together
    logw = torch.cat([torch.from_numpy(chain.logits).double(),
                      torch.full((v, 1), _BACKGROUND + np.log(v - nb),
                                 dtype=torch.float64)], dim=1)
    probs = torch.softmax(logw, dim=1)
    ssorted = torch.sort(succ, dim=1).values
    first = tok = torch.randint(0, v, (batch,), generator=gen)
    toks = []
    for _ in range(seq):
        c = torch.multinomial(probs[tok], 1, generator=gen)[:, 0]
        # the r-th non-successor: step r over the sorted successors
        r = torch.randint(0, v - nb, (batch,), generator=gen)
        for j in range(nb):
            r = r + (r >= ssorted[tok, j]).long()
        nxt = torch.where(c < nb, succ[tok, c.clamp(max=nb - 1)], r)
        toks.append(nxt)
        tok = nxt
    labels = torch.stack(toks, dim=1)
    tokens = torch.cat([first[:, None], labels[:, :-1]], dim=1)
    return {"tokens": tokens.to(dev), "labels": labels.to(dev)}
