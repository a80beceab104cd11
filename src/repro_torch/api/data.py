"""Session data sources: checkpointable wrappers over ``data/pipeline.py``
(the reference's ``api/data.py``).

A data source yields backend-shaped batches and serializes its host-side
cursor (the numpy bit generator's state and the slot cursor) as JSON, in the
reference's schema, so that a restored session replays exactly the batches
the interrupted run would have seen, whichever package saved it.

Batch shapes:
  * ring backends take ``(slot, tokens, labels)`` triples, tokens and labels
    ``[S, M, mb, seq]`` numpy (slot None for streaming draws); a
    multi-tenant session's are ``[S, T, M, mb, seq]``, one stream a tenant
    behind one shared slot cursor (a joint round touches the same slot for
    every tenant: the partitioned cache's key);
  * the pjit backend takes ``Batcher``'s flat numpy dicts
    (``{"tokens", "labels"}``; a QA config's ``{"tokens", "starts", "ends"}``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import Batcher, RingBatcher, make_client_datasets, merged

# tenant t draws from seed + 7919 t; tenant 0's stream is the one-tenant
# stream, which the joint-against-solo oracle relies on
TENANT_SEED_STRIDE = 7919


class RingDataSource:
    """Per-client ring batches; slot-keyed when ``slots_per_epoch`` is set
    (the activation cache's key contract).

    ``tenants=T > 1`` stacks T independent streams (tenant t's corpora and
    draws from ``tc.seed + 7919 t``) into ``[S, T, M, mb, seq]`` batches
    behind one slot cursor; ``tenant=k`` builds the one-tenant source that
    replays tenant k's slice of that stream (the solo side of the
    joint-against-solo oracle)."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, n_stages: int, *,
                 slots_per_epoch: Optional[int] = None, n_per_client: int = 128,
                 tenants: int = 1, tenant: Optional[int] = None):
        tenant_ids = [tenant] if tenant is not None else range(tenants)
        self.rbs: List[RingBatcher] = []
        for t in tenant_ids:
            seed = tc.seed + TENANT_SEED_STRIDE * t
            clients = make_client_datasets(n_stages, vocab=cfg.vocab_size,
                                           n_per_client=n_per_client, seq=tc.seq_len, seed=seed)
            self.rbs.append(RingBatcher(clients, tc.n_microbatches, tc.batch_size, seed=seed,
                                        slots_per_epoch=slots_per_epoch))
        self.T = len(self.rbs)

    @property
    def rb(self) -> RingBatcher:
        """The first tenant's batcher (the only one at one tenant)."""
        return self.rbs[0]

    def next(self) -> Tuple[Optional[int], Any, Any]:
        if self.rb.slots_per_epoch:
            draws = [rb.next_slot() for rb in self.rbs]
            slots = {d[0] for d in draws}
            assert len(slots) == 1, slots                # one shared slot cursor
            slot = draws[0][0]
        else:
            draws = [(None,) + tuple(rb.next()) for rb in self.rbs]
            slot = None
        if self.T == 1:
            return draws[0]
        return (slot, np.stack([d[1] for d in draws], axis=1),
                np.stack([d[2] for d in draws], axis=1))

    def state(self) -> Dict[str, Any]:
        if self.T == 1:                    # the one-tenant schema
            return {"rng": self.rb.rng.bit_generator.state, "t": self.rb._t}
        return {"tenants": [{"rng": rb.rng.bit_generator.state, "t": rb._t}
                            for rb in self.rbs]}

    def load_state(self, state: Dict[str, Any]) -> None:
        cursors = state.get("tenants", [state])
        if len(cursors) != self.T:
            raise ValueError(f"a data cursor of {len(cursors)} tenants for a source of "
                             f"{self.T}")
        for rb, st in zip(self.rbs, cursors):
            rb.rng.bit_generator.state = st["rng"]
            rb._t = int(st["t"])


class PjitDataSource:
    """Merged-client flat batches for the one-device (pjit) backend: the QA
    corpus for a span head (``{"tokens", "starts", "ends"}``), else the LM
    corpus (``{"tokens", "labels"}``)."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, *, n_clients: int = 4,
                 n_per_client: int = 256):
        kind = "qa" if cfg.head_out == 2 else "lm"
        ds = merged(make_client_datasets(n_clients, vocab=cfg.vocab_size,
                                         n_per_client=n_per_client, seq=tc.seq_len,
                                         seed=tc.seed, kind=kind))
        self.batcher = Batcher(ds, tc.batch_size, seed=tc.seed)

    def next(self) -> Dict[str, Any]:
        return self.batcher.next()

    def state(self) -> Dict[str, Any]:
        return {"rng": self.batcher.rng.bit_generator.state}

    def load_state(self, state: Dict[str, Any]) -> None:
        self.batcher.rng.bit_generator.state = state["rng"]
