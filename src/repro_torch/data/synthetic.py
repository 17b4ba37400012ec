"""Deterministic synthetic data (port of ``repro.data.synthetic``): the
Markov LM stream, the seq2seq reversal task, NCF implicit feedback from a
low-rank preference matrix, and CIFAR-shaped class-conditional blobs.

``make_markov_table`` is the reference's numpy construction, bit for bit:
each token has ``branching`` likely successors with logits ~ N(2, 0.5),
every other successor -4.  A dense [V, V] table does not fit at a full
vocabulary (122,753^2 f32 is 60 GB), so the sampler works on the same
chain kept sparse (:class:`MarkovChain`: the successors and their logits;
``dense()`` rebuilds the table), and draws each next token from
softmax(table[tok]) exactly: a successor or the background bucket by
their total weights, then a uniform non-successor within the bucket.

Every batch is drawn from an explicit ``torch.Generator`` on the CPU and
moved to ``device``; each task's fixed structure (the chain, the
preference matrix, the class centers) is a function of the seed.
:class:`HostPrefetcher` generates the next batches on a thread.  The
distributions are the reference's; JAX's random stream cannot be
reproduced, so parity tests feed JAX batches as numpy.
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


def seq2seq_batch(gen: torch.Generator, batch: int, src_len: int,
                  tgt_len: int, vocab: int, device=None):
    """Reversal: the target is the reversed source, shifted right behind a
    BOS (token 1) for teacher forcing; source tokens uniform in [2,
    vocab).  Returns {"enc_tokens" [B, src_len], "dec_tokens", "dec_labels"
    [B, tgt_len]} int64 on ``device``."""
    dev = resolve_device(device)
    src = torch.randint(2, vocab, (batch, src_len), generator=gen)
    rev = torch.flip(src, dims=(1,))[:, :tgt_len]
    bos = torch.ones((batch, 1), dtype=torch.int64)
    dec_in = torch.cat([bos, rev[:, :-1]], dim=1)
    return {"enc_tokens": src.to(dev), "dec_tokens": dec_in.to(dev),
            "dec_labels": rev.to(dev)}


@dataclasses.dataclass(frozen=True)
class Preferences:
    """The fixed low-rank user x item preference factors of an NCF task."""
    users: torch.Tensor      # [n_users, rank] f32
    items: torch.Tensor      # [n_items, rank] f32


def ncf_preferences(seed: int, n_users: int, n_items: int, rank: int = 8
                    ) -> Preferences:
    """Standard normal factors drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return Preferences(torch.randn((n_users, rank), generator=gen),
                       torch.randn((n_items, rank), generator=gen))


def ncf_batch(prefs: Preferences, gen: torch.Generator, batch: int,
              device=None):
    """Implicit feedback: uniform (user, item) pairs, label 1 with
    probability sigmoid(2 <u, i> / sqrt(rank)).  Returns {"users",
    "items", "labels"} [B] int64 on ``device``."""
    dev = resolve_device(device)
    n_users, rank = prefs.users.shape
    users = torch.randint(0, n_users, (batch,), generator=gen)
    items = torch.randint(0, prefs.items.shape[0], (batch,), generator=gen)
    score = (prefs.users[users] * prefs.items[items]).sum(-1) / rank ** 0.5
    prob = torch.sigmoid(2.0 * score)
    labels = (torch.rand((batch,), generator=gen) < prob).long()
    return {"users": users.to(dev), "items": items.to(dev),
            "labels": labels.to(dev)}


def cifar_centers(seed: int, n_classes: int = 10) -> torch.Tensor:
    """The class centers [n_classes, 32, 32, 3], N(0, 0.8^2), from
    ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n_classes, 32, 32, 3), generator=gen) * 0.8


def cifar_batch(centers: torch.Tensor, gen: torch.Generator, batch: int,
                device=None):
    """Class-conditional Gaussian blobs at CIFAR-10 shapes: a uniform label,
    its center plus N(0, 0.6^2) noise.  Returns {"images" [B, 32, 32, 3]
    f32, "labels" [B] int64} on ``device``."""
    dev = resolve_device(device)
    labels = torch.randint(0, centers.shape[0], (batch,), generator=gen)
    noise = torch.randn((batch,) + tuple(centers.shape[1:]),
                        generator=gen) * 0.6
    return {"images": (centers[labels] + noise).to(dev),
            "labels": labels.to(dev)}


class HostPrefetcher:
    """Overlaps next-batch generation with the current step (a one-worker
    thread pool): ``get(step)`` returns ``gen_fn(step)`` and has the next
    ``n_prefetch - 1`` steps' batches generating meanwhile.  ``gen_fn``
    must be a function of the step alone (as the launchers' batches are:
    a generator seeded from (seed, step)), so prefetched batches equal
    direct generation.  Not wired into ``TrainLoop``."""

    def __init__(self, gen_fn, n_prefetch: int = 2):
        import concurrent.futures as cf
        self._gen = gen_fn
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending = {}
        self._n = n_prefetch

    def get(self, step: int):
        for s in range(step, step + self._n):
            if s not in self._pending:
                self._pending[s] = self._pool.submit(self._gen, s)
        fut = self._pending.pop(step)
        return fut.result()

    def close(self) -> None:
        """Drop the batches not taken and stop the worker."""
        for fut in self._pending.values():
            fut.cancel()
        self._pending.clear()
        self._pool.shutdown(wait=True)
