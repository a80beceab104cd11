"""Synthetic per-client corpora and batchers (numpy only).

A copy of the reference's ``data/pipeline.py`` without JAX: RingAda's U
clients hold private datasets with client-specific distributions (distinct
bigram transition tables). The same seed gives the same tokens as the
reference, element for element. Batches are numpy arrays; :func:`to_device`
moves one onto a device as int64 tensors.

Task flavours: ``lm`` (next-token prediction, labels = tokens shifted by 1)
and ``qa`` (a marked answer span; labels = (start, end)).

``Batcher`` draws flat batches for the single-device step; ``RingBatcher``
draws every client's ``[M, mb, seq]`` microbatches for a ring round, from
its own data only, afresh each round or from epoch-stable batch slots.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ClientDataset:
    client_id: int
    tokens: np.ndarray              # [N, seq] int32
    labels: np.ndarray              # [N, seq] int32 (lm) or [N, 2] (qa)
    kind: str = "lm"

    def __len__(self):
        return self.tokens.shape[0]


def _markov_corpus(rng: np.random.Generator, vocab: int, n: int, seq: int,
                   order_bias: float) -> np.ndarray:
    """Client-specific bigram process: next ~ (cur * a + b) mod vocab + noise."""
    a = int(rng.integers(3, 23)) * 2 + 1
    b = int(rng.integers(1, vocab - 1))
    toks = np.empty((n, seq), np.int32)
    cur = rng.integers(0, vocab, size=n)
    for t in range(seq):
        toks[:, t] = cur
        noise = rng.random(n) < order_bias
        nxt = (cur * a + b) % vocab
        cur = np.where(noise, rng.integers(0, vocab, size=n), nxt)
    return toks


def make_client_datasets(n_clients: int, *, vocab: int, n_per_client: int,
                         seq: int, seed: int = 0, kind: str = "lm",
                         ) -> List[ClientDataset]:
    out = []
    for u in range(n_clients):
        rng = np.random.default_rng(seed * 1000 + u)
        toks = _markov_corpus(rng, vocab, n_per_client, seq + 1, 0.15)
        if kind == "lm":
            ds = ClientDataset(u, toks[:, :-1].astype(np.int32),
                               toks[:, 1:].astype(np.int32), "lm")
        elif kind == "qa":
            # answer span marked by sentinel tokens; labels = span indices
            toks2 = toks[:, :seq].copy()
            starts = rng.integers(1, seq - 8, size=n_per_client)
            lens = rng.integers(1, 6, size=n_per_client)
            ends = np.minimum(starts + lens, seq - 2)
            sent = vocab - 1
            for i in range(n_per_client):
                toks2[i, starts[i] - 1] = sent       # answer-begin marker
                toks2[i, ends[i] + 1] = sent - 1     # answer-end marker
            ds = ClientDataset(u, toks2.astype(np.int32),
                               np.stack([starts, ends], -1).astype(np.int32), "qa")
        else:
            raise ValueError(kind)
        out.append(ds)
    return out


class Batcher:
    """Flat [B, seq] numpy batches for the single-device path."""

    def __init__(self, dataset: ClientDataset, batch: int, seed: int = 0):
        self.d, self.B = dataset, batch
        self.rng = np.random.default_rng(seed)

    def next(self) -> Dict[str, np.ndarray]:
        idx = self.rng.integers(0, len(self.d), size=self.B)
        out = {"tokens": self.d.tokens[idx]}
        if self.d.kind == "lm":
            out["labels"] = self.d.labels[idx]
        else:
            lab = self.d.labels[idx]
            out["starts"] = lab[:, 0]
            out["ends"] = lab[:, 1]
        return out


class RingBatcher:
    """``[S, M, mb, seq]`` numpy batches for ring rounds: client u's M
    microbatches of ``mb`` rows, from its own dataset.

    Two modes, the reference's:

      * :meth:`next`: a fresh random draw at every call (streaming; no batch
        identity across rounds);
      * :meth:`next_slot` (needs ``slots_per_epoch``): the epoch is a fixed
        cycle of ``slots_per_epoch`` batch slots, whose examples are drawn
        once at construction from a generator of their own
        (``SeedSequence([seed, 1])``, so ``next`` draws do not move them) and
        reused every epoch: slot i holds the same tokens and labels in every
        epoch and after re-instantiation with the same seed. That is the
        activation cache's key contract (``core/actcache.py``).
    """

    def __init__(self, datasets: List[ClientDataset], n_micro: int, micro_batch: int,
                 seed: int = 0, slots_per_epoch: Optional[int] = None):
        self.ds = datasets
        self.M, self.mb = n_micro, micro_batch
        self.rng = np.random.default_rng(seed)
        self.slots_per_epoch = slots_per_epoch
        self._t = 0
        # keyed by slot: the cursor may start mid-epoch (a restored run)
        self._slot_batches: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        if slots_per_epoch is not None:
            if slots_per_epoch < 1:
                raise ValueError(f"slots_per_epoch must be >= 1, got {slots_per_epoch}")
            srng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
            n = self.M * self.mb
            self._slot_idx = [[srng.integers(0, len(d), size=n) for d in datasets]
                              for _ in range(slots_per_epoch)]

    def _stack(self, idx_per_ds) -> Tuple[np.ndarray, np.ndarray]:
        toks = [d.tokens[i].reshape(self.M, self.mb, -1) for d, i in zip(self.ds, idx_per_ds)]
        labs = [d.labels[i].reshape(self.M, self.mb, -1) for d, i in zip(self.ds, idx_per_ds)]
        return np.stack(toks), np.stack(labs)

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, labels), each [S, M, mb, seq] int32."""
        return self._stack([self.rng.integers(0, len(d), size=self.M * self.mb)
                            for d in self.ds])

    def next_slot(self) -> Tuple[int, np.ndarray, np.ndarray]:
        """(slot, tokens, labels): the slots 0 .. slots_per_epoch - 1 in turn,
        forever; each slot's batch is assembled once and reused every epoch."""
        if self.slots_per_epoch is None:
            raise ValueError("RingBatcher built without slots_per_epoch; use next() or pass "
                             "slots_per_epoch")
        slot = self._t % self.slots_per_epoch
        self._t += 1
        if slot not in self._slot_batches:
            self._slot_batches[slot] = self._stack(self._slot_idx[slot])
        toks, labs = self._slot_batches[slot]
        return slot, toks, labs

    @property
    def epoch(self) -> int:
        return 0 if self.slots_per_epoch is None else self._t // self.slots_per_epoch


def merged(datasets: List[ClientDataset]) -> ClientDataset:
    return ClientDataset(-1,
                         np.concatenate([d.tokens for d in datasets]),
                         np.concatenate([d.labels for d in datasets]),
                         datasets[0].kind)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as int64 tensors on ``device`` (token ids index the embedding)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long().to(device)
            for k, v in batch.items()}
