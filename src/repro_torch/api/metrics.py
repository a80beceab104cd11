"""RoundMetrics and the session's callback hooks (the reference's
``api/metrics.py``).

``RoundMetrics`` is the record one ``RingSession.step`` returns. The loss and
the ``extras`` of a fused round are device tensors until ``materialize()``:
the session materializes in batches (once per logging interval), so holding
an unmaterialized RoundMetrics never waits for the device. The executor's
rounds return clones of their graph's outputs, so a held tensor survives the
next replay.

Callbacks see materialized metrics only, so a callback never syncs the
device mid-interval:

    on_start(session)            before the first step of ``run``
    on_round(session, metrics)   once per step, at materialization time
    on_end(session, history)     after the last step (history = list of dicts)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.core.executor import scalarize as _scalarize


@dataclass(eq=False)                       # identity hash: the session tracks
class RoundMetrics:                        # live instances in a WeakSet
    """One training step or round.

    ``loss`` (and ``extras`` values) may be device tensors before
    ``materialize()``; every other field is host-side from birth.
    """

    step: int                          # global step AFTER this round
    boundary: int                      # frozen repeats from the bottom
    depth: int                         # unfrozen blocks from the top
    loss: Any                          # scalar (a device tensor until materialized)
    compile_count: int = 0             # rounds or steps built so far (cumulative)
    tokens: int = 0                    # tokens consumed by this round
    tokens_per_sec: Optional[float] = None   # filled at materialization
    wall_s: Optional[float] = None           # since run() start
    round_ms: Optional[float] = None         # the logging interval's wall ms per round
    cache: Optional[Dict[str, Any]] = None   # actcache stats, if caching
    cache_hit: Optional[bool] = None
    extras: Dict[str, Any] = field(default_factory=dict)
    materialized: bool = False

    def materialize(self, *, wall_s: Optional[float] = None,
                    tokens_per_sec: Optional[float] = None,
                    round_ms: Optional[float] = None) -> "RoundMetrics":
        """Host-sync every device value -> a new, fully scalar RoundMetrics."""
        timing = dict(wall_s=self.wall_s if wall_s is None else wall_s,
                      tokens_per_sec=self.tokens_per_sec if tokens_per_sec is None
                      else tokens_per_sec,
                      round_ms=self.round_ms if round_ms is None else round_ms)
        if self.materialized:
            # already scalar (a loss-driven policy synced early): the timing only
            return dataclasses.replace(self, **timing)
        return dataclasses.replace(
            self, loss=_scalarize(self.loss),
            extras={k: _scalarize(v) for k, v in self.extras.items()},
            materialized=True, **timing)

    def flush_(self) -> "RoundMetrics":
        """Host-sync IN PLACE (``materialize`` returns a copy; this mutates).

        The session calls this on every outstanding metric before a backend
        call that changes the tensors it holds (``repartition``, a checkpoint
        load), so that no history entry reads the state after the change.
        Idempotent; the timing fields are left to the run loop's flush."""
        if not self.materialized:
            self.loss = _scalarize(self.loss)
            self.extras = {k: _scalarize(v) for k, v in self.extras.items()}
            self.materialized = True
        return self

    def to_dict(self) -> Dict[str, Any]:
        """Flat history dict: loss/boundary/step/depth/wall_s at the top,
        cache stats as cache_*, extras merged in."""
        assert self.materialized, "materialize() before to_dict()"
        out = {"loss": self.loss, "boundary": self.boundary,
               "step": self.step, "depth": self.depth}
        if self.wall_s is not None:
            out["wall_s"] = self.wall_s
        if self.tokens_per_sec is not None:
            out["tokens_per_sec"] = round(self.tokens_per_sec, 2)
        if self.round_ms is not None:
            out["round_ms"] = self.round_ms
        out["compile_count"] = self.compile_count
        if self.cache is not None:
            out.update(self.cache)
            out["cache_hit"] = self.cache_hit
        out.update(self.extras)
        return out


# ---------------------------------------------------------------------------
# Callbacks
# ---------------------------------------------------------------------------


class Callback:
    """Base class: override any subset of the hooks."""

    def on_start(self, session) -> None:
        pass

    def on_round(self, session, metrics: RoundMetrics) -> None:
        pass

    def on_end(self, session, history: List[Dict[str, Any]]) -> None:
        pass


class LoggingCallback(Callback):
    """One line a logged step, plus a guaranteed final-state line (the
    cadence follows materialization batches, so asynchronous rounds stay so).

    The lines are the port's CLI's: a ring round as ``round r boundary b
    depth d loss x round_ms t`` (and ``cache_hit h`` with a cache, and
    ``[elastic S=n]`` after a round that moved an elastic ring's layout),
    ``r`` counting from the run's first round ever (a resumed run goes on
    counting; ``?`` where the checkpoint does not say); a one-device step as
    ``step s boundary b loss x accuracy a grad_norm g`` (and ``moe_aux x
    moe_z z`` for a model with moe blocks), ``s`` the step's index, and a QA
    step as ``step s boundary b loss x em e f1 f`` (the
    reference's ``acc/f1=`` shows its F1 there)."""

    def __init__(self, log=print, every: int = 1):
        self.log = log
        self.every = max(every, 1)
        self._n = 0
        self._last_step: Optional[int] = None

    def _emit(self, d: Dict[str, Any]) -> None:
        self._last_step = d["step"]
        if "round" in d:
            hit = "" if d.get("cache_hit") is None else f" cache_hit {d['cache_hit']}"
            ms = d.get("round_ms")
            # a round that shrank, grew or repartitioned the ring is marked, so
            # that the loss blip after it reads as recovery, not divergence
            el = ""
            if d.get("layout_changed"):
                surv = d.get("survivors")
                el = " [elastic]" if surv is None else f" [elastic S={len(surv)}]"
            r = "?" if d["round"] is None else d["round"]
            self.log(f"round {r} boundary {d['boundary']} depth {d['depth']} "
                     f"loss {d['loss']:.4f} round_ms {ms if ms is None else f'{ms:.1f}'}"
                     f"{hit}{el}")
        elif "f1" in d:                   # the QA step: EM and F1 of the argmax spans
            self.log(f"step {d['step'] - 1} boundary {d['boundary']} loss {d['loss']:.4f} "
                     f"em {d['em']:.4f} f1 {d['f1']:.4f}")
        else:
            moe = "".join(f" {k} {d[k]:.4g}" for k in ("moe_aux", "moe_z") if k in d)
            self.log(f"step {d['step'] - 1} boundary {d['boundary']} loss {d['loss']:.4f} "
                     f"accuracy {d.get('accuracy', float('nan')):.4f} "
                     f"grad_norm {d.get('grad_norm', float('nan')):.4g}{moe}")

    def on_round(self, session, m: RoundMetrics) -> None:
        self._n += 1
        if (self._n - 1) % self.every == 0:
            self._emit(m.to_dict())

    def on_end(self, session, history) -> None:
        # the run's final state always gets a line, aligned interval or not
        if history and history[-1]["step"] != self._last_step:
            self._emit(history[-1])


class CheckpointCallback(Callback):
    """``session.save(path)`` every N observed rounds (and at on_end).

    Rounds are observed at materialization time, so the effective checkpoint
    granularity is bounded below by ``run``'s ``log_every``, and the state
    saved is the session's CURRENT state (a flush delivering many rounds at
    once makes ONE save, not one a round)."""

    def __init__(self, path: str, every: int = 50):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.path = path
        self.every = every
        self._n = 0
        self._saved_at: Optional[int] = None

    def _save_once(self, session) -> None:
        if session.step_count != self._saved_at:
            session.save(self.path)
            self._saved_at = session.step_count

    def on_round(self, session, m: RoundMetrics) -> None:
        self._n += 1
        if self._n % self.every == 0:
            self._save_once(session)

    def on_end(self, session, history) -> None:
        self._save_once(session)


class BenchCaptureCallback(Callback):
    """Captures the trajectory (loss, tokens per second, compile counts,
    cache hit rate a round) for benchmark harnesses."""

    def __init__(self):
        self.rounds: List[Dict[str, Any]] = []

    def on_round(self, session, m: RoundMetrics) -> None:
        self.rounds.append(m.to_dict())

    def result(self) -> Dict[str, Any]:
        if not self.rounds:
            return {}
        last = self.rounds[-1]
        tps = [r["tokens_per_sec"] for r in self.rounds if r.get("tokens_per_sec")]
        out = {"rounds": len(self.rounds),
               "final_loss": last["loss"],
               "final_boundary": last["boundary"],
               "compile_count": last["compile_count"],
               "boundary_trace": [r["boundary"] for r in self.rounds]}
        if tps:
            out["tokens_per_sec_steady"] = tps[-1]
        if "cache_hit_rate" in last:
            out["cache_hit_rate"] = last["cache_hit_rate"]
        return out
