"""Session data sources: checkpointable wrappers over ``data/pipeline.py``
(the reference's ``api/data.py``, one tenant).

A data source yields backend-shaped batches and serializes its host-side
cursor (the numpy bit generator's state and the slot cursor) as JSON, in the
reference's schema, so that a restored session replays exactly the batches
the interrupted run would have seen, whichever package saved it.

Batch shapes:
  * ring backends take ``(slot, tokens, labels)`` triples, tokens and labels
    ``[S, M, mb, seq]`` numpy (slot None for streaming draws);
  * the pjit backend takes ``Batcher``'s flat numpy dicts
    (``{"tokens", "labels"}``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import Batcher, RingBatcher, make_client_datasets, merged


class RingDataSource:
    """Per-client ring batches; slot-keyed when ``slots_per_epoch`` is set
    (the activation cache's key contract). ``tenants`` > 1 waits for ROADMAP
    Queue 1 item 8 (multi-tenant)."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, n_stages: int, *,
                 slots_per_epoch: Optional[int] = None, n_per_client: int = 128,
                 tenants: int = 1):
        if tenants != 1:
            raise NotImplementedError(
                f"tenants={tenants}: multi-tenant ring data waits for ROADMAP Queue 1 item 8")
        clients = make_client_datasets(n_stages, vocab=cfg.vocab_size,
                                       n_per_client=n_per_client, seq=tc.seq_len, seed=tc.seed)
        self.rb = RingBatcher(clients, tc.n_microbatches, tc.batch_size, seed=tc.seed,
                              slots_per_epoch=slots_per_epoch)

    def next(self) -> Tuple[Optional[int], Any, Any]:
        if self.rb.slots_per_epoch:
            return self.rb.next_slot()
        tokens, labels = self.rb.next()
        return None, tokens, labels

    def state(self) -> Dict[str, Any]:
        return {"rng": self.rb.rng.bit_generator.state, "t": self.rb._t}

    def load_state(self, state: Dict[str, Any]) -> None:
        if "tenants" in state:
            raise NotImplementedError("a multi-tenant data cursor waits for ROADMAP Queue 1 "
                                      "item 8")
        self.rb.rng.bit_generator.state = state["rng"]
        self.rb._t = int(state["t"])


class PjitDataSource:
    """Merged-client flat batches for the one-device (pjit) backend, LM
    objective. A QA head waits for ROADMAP Queue 1 item 12."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, *, n_clients: int = 4,
                 n_per_client: int = 256):
        if cfg.head_out is not None:
            raise NotImplementedError(f"{cfg.name}: a task head (head_out={cfg.head_out}) "
                                      f"and its QA data wait for ROADMAP Queue 1 item 12")
        ds = merged(make_client_datasets(n_clients, vocab=cfg.vocab_size,
                                         n_per_client=n_per_client, seq=tc.seq_len,
                                         seed=tc.seed))
        self.batcher = Batcher(ds, tc.batch_size, seed=tc.seed)

    def next(self) -> Dict[str, Any]:
        return self.batcher.next()

    def state(self) -> Dict[str, Any]:
        return {"rng": self.batcher.rng.bit_generator.state}

    def load_state(self, state: Dict[str, Any]) -> None:
        self.batcher.rng.bit_generator.state = state["rng"]
