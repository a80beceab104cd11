"""The port's elastic ring (churn events, the straggler detector,
``RingExecutor.shrink``/``grow``, ``ChaosBackend``, elastic sessions and the
CLI's ``--chaos``/``--elastic``) against the JAX package's, on the CPU.

The reduced stablelm-3b of tests/test_elastic.py in f32: 14 layers, d_model
64, d_ff 128, vocab 128, a ring of S = 4 stages, M = 2 microbatches of 1 x 16
tokens per client, depth 3 (boundary 11) unless a test says otherwise.

  (a) the copies equal the reference on the same inputs, exactly:
      ``ChurnEvent``'s validation, ``parse_chaos_events``, ``apply_churn``,
      ``DeviceProfile.slowed`` and the ``StragglerDetector`` (speeds,
      proposals, streaks and errors, round by round);
  (b) shrink, in tests/test_elastic.py's three cases (4:5:2:3 kill 2, 4:4:3:3
      kill 0, 4:5:2:3 kill 3; a cache of 2): the spans and boundary equal the
      JAX ``predict_recovery``, the measured capture and cached tick ledgers
      equal its recovery and steady prices and ``spmd_tick_round`` exactly,
      the four rounds after the shrink equal a from-scratch S - 1 executor
      and the port's ``RingTrainer`` bit for bit (hits F, F, T, T), and no
      state tensor was reallocated. The JAX ``RingExecutor`` is not the
      oracle for the numbers: it sums the head's gradient a second time
      (tests/test_torch_executor.py), so its rounds are held to nothing here;
  (c) relayout against the reference: one state before the shrink, loaded
      into both packages, gives the same state after each package's
      ``shrink``, leaf for leaf; a checkpoint the port saved after a shrink
      restores in the JAX package (the same survivors and spans), and the
      JAX session's save of it restores in the port, bit for bit, and
      continues as the port's uninterrupted run;
  (d) sessions (tests/test_elastic.py's): a kill completes and resumes bit
      for bit and a crash without ``elastic`` raises; a straggler triggers
      one repartition, to 4:5:2:3, at round 1, with stage times 4.0; a crash
      and a rejoin give sizes [4, 4, 3, 3, 3, 4, 4, 4] (and at depth 5 a
      boundary that rises at the rejoin), every round equal to a
      from-scratch executor at the live spans, and a device never seen is
      refused; a stale layout is repaired on restore. The marks, survivors,
      spans, boundaries, stage times, cache hits, log lines, refusals and
      counts equal the JAX package's own fused and cached sessions (its
      ``RingSession``, ``ChaosBackend`` and ``RingExecutor``) up to the
      round after the last change (a JAX round compiles for seconds on one
      core), and the resumed runs' round indices are held too;
  (e) tenants through a shrink (tests/test_tenants.py's elastic case): a
      joint T = 3 cached ring under ``"2:crash:3"``: another stream for
      tenant 2 leaves tenants 0 and 1 bit for bit unchanged, round 2 alone
      is marked, the survivors are [0, 1, 2] on 3 spans, the hits F, F, F,
      F, T, T;
  (f) the CLI: ``--chaos 3:crash:2 --elastic`` prints the ``[elastic]``
      line and finishes, ``--chaos`` without ``--elastic`` raises naming it,
      ``--mode pjit --chaos`` is refused.

The JAX package's executors and sessions for (c) and (d) run once for the
file, in one subprocess on four host devices (XLA's optimisations off).
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import elastic as jax_elastic  # noqa: E402
from repro.core import partition as jax_partition  # noqa: E402
from repro.core import simulator as jax_sim  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import RingSession  # noqa: E402
from repro_torch.api.data import RingDataSource  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import elastic, partition, simulator  # noqa: E402
from repro_torch.core.executor import RingExecutor  # noqa: E402
from repro_torch.core.ring import RingTrainer  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, M, MB, SEQ, LAYERS = 4, 2, 1, 16, 14
LR, DEPTH = 1e-3, 3
SPEEDS = [1.0, 1.25, 0.5, 0.75]
SHRINK_CASES = [("4:5:2:3/kill2", [4, 5, 2, 3], 2), ("4:4:3:3/kill0", [4, 4, 3, 3], 0),
                ("4:5:2:3/kill3", [4, 5, 2, 3], 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (tests/test_torch_executor.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*_):
    pass


def _configs():
    kw = dict(n_layers=LAYERS, repeats=LAYERS, d_model=64, d_ff=128, vocab_size=128,
              dtype="float32")
    return jax_get_config("stablelm-3b").reduced(**kw), get_config("stablelm-3b").reduced(**kw)


def _tc(depth=DEPTH, **kw):
    return TrainConfig(**{**dict(seed=0, learning_rate=LR, unfreeze_interval=10**6,
                                 initial_unfreeze_depth=depth, n_stages=S, n_microbatches=M,
                                 batch_size=MB, seq_len=SEQ), **kw})


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The port's seed weights in JAX's layout (numpy leaves, read only), the
    adapters perturbed from a numpy seed (W_up != 0, so that a round moves
    every hot adapter)."""
    _, tcfg = _configs()
    p = bridge.params_to_jax(prm.materialize(tcfg, seed=0, device="cpu"), tcfg)
    rng = np.random.default_rng(1)
    (e,) = p["blocks"]
    ad = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(v.dtype)
          for k, v in e["adapter"].items()}
    return {**p, "blocks": ({**e, "adapter": ad},)}


def _params():
    return bridge.params_from_jax(_jax_params(), _configs()[1], device="cpu")


def _session(backend="fused", tc=None, **kw):
    kw = {"n_stages": S, "params": _params(), "device": "cpu", "log": _quiet, **kw}
    return RingSession.create(_configs()[1], tc or _tc(), backend=backend, **kw)


def _spans(spans):
    return [list(sp) for sp in spans]


def _copy_state(dst, src_tensors, step):
    """Seed executor ``dst`` with a snapshot of trainable tensors (a
    ``trainable_tensors()`` list: the flat layer order does not depend on the
    layout) and a step."""
    for a, b in zip(dst.trainable_tensors(), src_tensors, strict=True):
        a.copy_(b)
    dst.step = step


def _raises(fn):
    """``fn()``'s exception as (type name, message); None if it returns."""
    try:
        fn()
    except Exception as e:                 # noqa: BLE001 - compared with the reference's
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------- (a) the copies


def test_churn_events_equal_jax():
    """``ChurnEvent``'s validation, ``parse_chaos_events`` and ``apply_churn``
    give the reference's events, fleets and error messages on the same inputs."""
    assert simulator.CHURN_KINDS == jax_sim.CHURN_KINDS
    bad_events = [dict(round=0, kind="explode", device=0), dict(round=-1, kind="crash", device=0),
                  dict(round=0, kind="crash", device=-2),
                  dict(round=0, kind="slowdown", device=0, factor=0.0),
                  dict(round=0, kind="slowdown", device=0, factor=float("nan"))]
    for kw in bad_events:
        got = _raises(lambda: simulator.ChurnEvent(**kw))
        assert got is not None and got == _raises(lambda: jax_sim.ChurnEvent(**kw)), kw
    fields = lambda evs: [(e.round, e.kind, e.device, e.factor) for e in evs]
    good = ["5:slowdown:1:4.0", "3:crash:2", "7:JOIN:2", "0:leave:0", "2:slowdown:3"]
    assert fields(elastic.parse_chaos_events(good)) == \
        fields(jax_elastic.parse_chaos_events(good))
    assert fields(elastic.parse_chaos_events(good))[0] == (0, "leave", 0, 2.0)
    for bad in ("3:crash", "a:crash:2", "3:crash:x", "3:crash:2:z", "3:explode:2", "1:2:3:4:5",
                "-1:crash:0", "1:slowdown:0:0"):
        got = _raises(lambda: elastic.parse_chaos_events([bad]))
        assert got is not None and got == _raises(lambda: jax_elastic.parse_chaos_events([bad]))
    as_jax = lambda ps: [jax_partition.DeviceProfile(p.compute_speed, p.memory_mb, p.link_mbps)
                         for p in ps]
    prof = lambda ps: [(p.compute_speed, p.memory_mb, p.link_mbps) for p in ps]
    fleet = partition.parse_device_profiles(SPEEDS)
    jfleet = as_jax(fleet)
    events = [dict(round=0, kind="crash", device=2), dict(round=1, kind="slowdown", device=0,
                                                          factor=2.0),
              dict(round=2, kind="join", device=2), dict(round=3, kind="leave", device=3),
              dict(round=4, kind="join", device=0)]
    for kw in events:
        ev, jev = simulator.ChurnEvent(**kw), jax_sim.ChurnEvent(**kw)
        before = prof(fleet)
        fleet, jfleet = simulator.apply_churn(fleet, ev), jax_sim.apply_churn(jfleet, jev)
        assert prof(fleet) == prof(jfleet), kw
        assert before != prof(fleet)
    joiner = partition.DeviceProfile(0.5, 100.0)
    f2 = simulator.apply_churn(fleet, simulator.ChurnEvent(round=0, kind="join", device=1,
                                                           profile=joiner))
    j2 = jax_sim.apply_churn(jfleet, jax_sim.ChurnEvent(
        round=0, kind="join", device=1, profile=jax_partition.DeviceProfile(0.5, 100.0)))
    assert prof(f2) == prof(j2) and f2[1] == joiner
    one = [partition.DeviceProfile(1.0, float("inf"))]
    for fl, jfl, kw in ((fleet, jfleet, dict(round=0, kind="crash", device=7)),
                        (one, as_jax(one), dict(round=0, kind="leave", device=0))):
        got = _raises(lambda: simulator.apply_churn(fl, simulator.ChurnEvent(**kw)))
        want = _raises(lambda: jax_sim.apply_churn(jfl, jax_sim.ChurnEvent(**kw)))
        assert got is not None and got == want, (got, want)


def test_device_profile_slowed_equals_jax():
    for speed, factor in ((2.0, 4.0), (1.25, 3.0), (0.5, 0.25)):
        p = partition.DeviceProfile(speed, 8.0, 7.0).slowed(factor)
        q = jax_partition.DeviceProfile(speed, 8.0, 7.0).slowed(factor)
        assert (p.compute_speed, p.memory_mb, p.link_mbps) == \
            (q.compute_speed, q.memory_mb, q.link_mbps)
    for bad in (0.0, -1.0, float("nan")):
        got = _raises(lambda: partition.DeviceProfile(2.0, 8.0).slowed(bad))
        assert got is not None and \
            got == _raises(lambda: jax_partition.DeviceProfile(2.0, 8.0).slowed(bad))


def _stage_times(spans, speeds):
    return [sz / s for sz, s in zip(partition.span_sizes(partition.normalize_spans(spans)),
                                    speeds)]


DETECTOR_CASES = {
    # spans 4:4:3:3 over the true speeds: fires once after patience 2, to 4:5:2:3
    "stable_skew": (SPEEDS, 14, [4, 4, 3, 3], [SPEEDS] * 6, {}),
    # unit profiles, device 2 truly 4x slower: the EWMA finds it
    "ewma_slowdown": ([1.0] * 4, 12, [3, 3, 3, 3], [[1.0, 1.0, 0.25, 1.0]] * 8,
                      dict(alpha=0.5, threshold=1.2, patience=2)),
    # one GC-pause round, then the true speeds: never fires
    "transient": ([1.0] * 4, 12, [3, 3, 3, 3], [[1.0, 1.0, 0.25, 1.0]] + [[1.0] * 4] * 4,
                  dict(patience=2)),
    "patience_3": (SPEEDS, 14, [4, 4, 3, 3], [SPEEDS] * 6, dict(alpha=0.3, patience=3)),
}


@pytest.mark.parametrize("case", sorted(DETECTOR_CASES))
def test_straggler_detector_equals_jax(case):
    """Round by round the EWMA speeds, the bottleneck, the proposals, the
    streak and the repartition count equal the reference's exactly (plain
    Python floats); the stable skew fires exactly once, to 4:5:2:3."""
    profiles, n_blocks, spans, truths, kw = DETECTOR_CASES[case]
    det = elastic.StragglerDetector(partition.parse_device_profiles(profiles), n_blocks, **kw)
    ref = jax_elastic.StragglerDetector(jax_partition.parse_device_profiles(profiles),
                                        n_blocks, **kw)
    spans = partition.normalize_spans(spans)
    props = []
    for truth in truths:
        times = _stage_times(spans, truth)
        det.observe(spans, times)
        ref.observe(spans, times)
        assert det.speeds == ref.speeds
        assert det.bottleneck(spans) == ref.bottleneck(spans)
        prop, want = det.propose(spans), ref.propose(spans)
        assert prop == want and (det.streak, det.repartitions) == (ref.streak, ref.repartitions)
        props.append(prop)
        if prop is not None:
            spans = prop
    fired = [p for p in props if p is not None]
    if case == "stable_skew":
        assert len(fired) == 1 and props[1] is not None and all(p is None for p in props[2:])
        assert partition.span_sizes(fired[0]) == (4, 5, 2, 3)
        assert det.bottleneck(spans) == 4.0
    elif case == "ewma_slowdown":
        assert abs(det.speeds[2] - 0.25) < 0.05 and partition.span_sizes(fired[0])[2] < 3
    elif case == "transient":
        assert not fired


def test_straggler_detector_membership_and_errors_equal_jax():
    det = elastic.StragglerDetector(partition.parse_device_profiles(SPEEDS), 14)
    ref = jax_elastic.StragglerDetector(jax_partition.parse_device_profiles(SPEEDS), 14)
    for d in (det, ref):
        d.observe([4, 4, 3, 3], [4.0, 3.0, 6.0, 4.0])
        d.remove(2)
    assert det.speeds == ref.speeds and det.streak == ref.streak == 0
    assert [p.compute_speed for p in det.fleet] == [p.compute_speed for p in ref.fleet]
    det.insert(2, partition.DeviceProfile(0.5, float("inf")))
    ref.insert(2, jax_partition.DeviceProfile(0.5, float("inf")))
    assert det.speeds == ref.speeds and len(det.fleet) == 4
    for kw in (dict(alpha=0.0), dict(alpha=1.5), dict(threshold=0.9)):
        got = _raises(lambda: elastic.StragglerDetector(det.fleet, 14, **kw))
        want = _raises(lambda: jax_elastic.StragglerDetector(ref.fleet, 14, **kw))
        assert got is not None and got == want
    assert _raises(lambda: det.observe([4, 4, 3, 3], [1.0] * 3)) == \
        _raises(lambda: ref.observe([4, 4, 3, 3], [1.0] * 3))


# ---------------------------------------------------------------- (b) shrink


def _jax_profiles(speeds):
    return jax_partition.parse_device_profiles(speeds)


@pytest.mark.parametrize("name,layout,dead", SHRINK_CASES, ids=[c[0] for c in SHRINK_CASES])
def test_shrink_geometry_ledgers_and_rounds(name, layout, dead):
    """Four cached rounds on ``layout``, then stage ``dead`` dies: the spans
    and boundary equal the JAX ``predict_recovery``, the capture (recovery)
    and cached (steady) ledgers equal its prices and ``spmd_tick_round``, the
    four rounds after the shrink equal a from-scratch S - 1 executor seeded
    with the same state and the port's ``RingTrainer`` at S - 1, bit for bit;
    no state tensor moved."""
    _, cfg = _configs()
    tc = _tc()
    gen = np.random.default_rng(7)
    batches = [tuple(gen.integers(0, cfg.vocab_size, (S, M, MB, SEQ)) for _ in range(2))
               for _ in range(2)]
    drv = RingExecutor(cfg, tc, _params(), S, M, spans=layout, cache_capacity=2)
    for r in range(4):
        drv.round(*batches[r % 2], slot=r % 2)
    b_pre = drv.boundary_at(drv.step)
    ptrs = [t.data_ptr() for t in drv.trainable_tensors()]
    surv = [p for i, p in enumerate(partition.parse_device_profiles(SPEEDS)) if i != dead]
    drv.shrink(dead, profiles=surv)
    assert [t.data_ptr() for t in drv.trainable_tensors()] == ptrs
    pred = jax_sim.predict_recovery(cfg.repeats,
                                    [s for i, s in enumerate(_jax_profiles(SPEEDS)) if i != dead],
                                    M, b_pre, slots_per_epoch=2)
    b = drv.boundary_at(drv.step)
    assert (drv.S, drv.spans, b) == (S - 1, pred["spans"], pred["boundary"])
    assert b <= b_pre

    state, step = [t.clone() for t in drv.trainable_tensors()], drv.step
    twin = RingExecutor(cfg, tc, _params(), S - 1, M, spans=drv.spans, cache_capacity=2)
    _copy_state(twin, state, step)
    trainer = RingTrainer(cfg, tc, _params(), S - 1, M, spans=drv.spans)
    ex_trainer = RingExecutor(cfg, tc, _params(), S - 1, M, spans=drv.spans)
    _copy_state(ex_trainer, state, step)
    _seed_trainer(trainer, ex_trainer)
    rows = [i for i in range(S) if i != dead]
    hits = []
    for r in range(4):
        t, lab = (x[rows] for x in batches[r % 2])
        got = drv.round(t, lab, slot=r % 2)
        want = twin.round(t, lab, slot=r % 2)
        oracle = trainer.round(t, lab)
        hits.append((got["cache_hit"], want["cache_hit"]))
        assert torch.equal(got["losses"], want["losses"]), (name, r)
        assert got["losses"].tolist() == [it["loss"] for it in oracle["iterations"]], (name, r)
        assert got["boundary"] == b == oracle["boundary"]
    for i, (x, y) in enumerate(zip(drv.trainable_tensors(), twin.trainable_tensors(),
                                   strict=True)):
        assert torch.equal(x, y), (name, i)
    _assert_equals_trainer(drv, trainer)
    assert hits == [(False, False), (False, False), (True, True), (True, True)]

    led_r, led_s = drv.measured_tick_ledger(b, "capture"), drv.measured_tick_ledger(b, "cached")
    F = led_r["frozen_stages"]
    sim_r = jax_sim.spmd_tick_round(drv.spans, M, b, packed=F >= 2)
    sim_s = jax_sim.spmd_tick_round(drv.spans, M, b, cached=True)
    assert led_r["phase_a_round_ticks"] == sim_r["phase_a_round_ticks"]
    assert led_s["phase_a_round_ticks"] == sim_s["phase_a_round_ticks"] == 0
    assert (led_r["frozen_stages"], led_r["hot_stages"]) == \
        (pred["frozen_stages"], pred["hot_stages"])
    S1 = S - 1
    assert led_r["phase_a_round_ticks"] + S1 * 2 * led_r["bwd_ticks"] == \
        pred["recovery_round_ticks"]
    assert led_s["phase_a_round_ticks"] + S1 * 2 * led_s["bwd_ticks"] == \
        pred["steady_round_ticks"]


def test_shrink_cases_cover_realignment_and_the_unpacked_recovery():
    """Across the three cases one realigns the boundary down and one lands at
    F < 2 (tests/test_elastic.py's coverage), computed from the geometry."""
    _, cfg = _configs()
    realign = unpacked = False
    for _, layout, dead in SHRINK_CASES:
        spans = partition.normalize_spans(layout, cfg.repeats)
        b_pre = partition.align_boundary(spans, cfg.repeats - DEPTH)
        surv = [p for i, p in enumerate(_jax_profiles(SPEEDS)) if i != dead]
        pred = jax_sim.predict_recovery(cfg.repeats, surv, M, b_pre)
        realign |= pred["boundary"] < b_pre
        unpacked |= pred["frozen_stages"] < 2
    assert realign and unpacked


def _seed_trainer(trainer, ex):
    """Copy executor ``ex``'s trainable state into ``RingTrainer`` ``trainer``."""
    for mine, theirs in ((trainer.stage_adapters(), ex.stage_adapters()),
                         (trainer.m_ad, ex.opt_state["m"]["adapter"]),
                         (trainer.v_ad, ex.opt_state["v"]["adapter"])):
        for a, b in zip(tree_leaves(mine), tree_leaves(theirs), strict=True):
            a.copy_(b)
    for mine, theirs in ((trainer.shared["head"], ex.shared["head"]),
                         (trainer.m_hd, ex.opt_state["m"]["head"]),
                         (trainer.v_hd, ex.opt_state["v"]["head"])):
        for k in mine:
            mine[k].copy_(theirs[k])
    trainer.step = ex.step


def _assert_equals_trainer(ex, trainer):
    for mine, theirs in ((ex.stage_adapters(), trainer.stage_adapters()),
                         (ex.opt_state["m"]["adapter"], trainer.m_ad),
                         (ex.opt_state["v"]["adapter"], trainer.v_ad),
                         (ex.shared["head"], trainer.shared["head"]),
                         (ex.opt_state["m"]["head"], trainer.m_hd),
                         (ex.opt_state["v"]["head"], trainer.v_hd)):
        for a, b in zip(tree_leaves(mine), tree_leaves(theirs), strict=True):
            assert torch.equal(a, b)
    assert ex.step == trainer.step


# ---------------------------------------------------------------- (c), (d): the JAX sessions

_JAX_RUN = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_disable_most_optimizations", True)
from repro import compat
from repro.api import RingSession
from repro.checkpoint import checkpoint as ckpt
from repro.configs import TrainConfig, get_config
from repro.core.executor import RingExecutor
from repro.core.partition import parse_device_profiles
from repro.models import params as P

src, tmp = sys.argv[1:3]
S, M, MB, SEQ, LAYERS, LR, DEPTH, SPEEDS, CASES = {consts}
cfg = get_config("stablelm-3b").reduced(n_layers=LAYERS, repeats=LAYERS, d_model=64, d_ff=128,
                                        vocab_size=128, dtype="float32")
structure = jax.tree.structure(P.param_defs(cfg), is_leaf=lambda x: isinstance(x, P.PD))
arrays = np.load(src)
params = jax.tree.unflatten(structure,
                            [jnp.asarray(arrays[f"leaf{{i}}"]) for i in range(len(arrays.files))])
tc = TrainConfig(seed=0, learning_rate=LR, unfreeze_interval=10**6, initial_unfreeze_depth=DEPTH,
                 n_stages=S, n_microbatches=M, batch_size=MB, seq_len=SEQ)
res = {{}}

# (c) relayout: the port's state before the shrink, loaded, shrunk, saved
mesh = compat.make_mesh((S,), ("stage",))
for i, (name, layout, dead) in enumerate(CASES):
    ex = RingExecutor(cfg, tc, mesh, params, S, M, spans=layout)
    p, _ = ckpt.restore(f"{{tmp}}/pre{{i}}", ex.export_params())
    ex.load_canonical(p)
    ex.opt_state = ckpt.restore_opt(f"{{tmp}}/pre{{i}}", ex.opt_state)
    surv = [q for j, q in enumerate(parse_device_profiles(SPEEDS)) if j != dead]
    ex.shrink(dead, profiles=surv)
    ckpt.save(f"{{tmp}}/post{{i}}", ex.export_params(), opt_state=ex.opt_state,
              adapters_only=True, extra={{"spans": [list(sp) for sp in ex.spans]}})
    del ex

# the port's checkpoint saved after a shrink, restored here and saved again
quiet = lambda *a: None
back = RingSession.restore(f"{{tmp}}/kill_ck", cfg, tc, params=params, log=quiet)
res["kill"] = {{"survivors": list(back.backend.survivors),
               "spans": [list(sp) for sp in back.backend.spans], "S": back.backend.S,
               "format": back.backend.format, "step": back.step_count,
               "shrinks": back.backend.shrinks}}
back.save(f"{{tmp}}/jax_kill_ck")
del back

# a stale layout repaired on restore, and kept without elastic
logs = []
fixed = RingSession.restore(f"{{tmp}}/stale_ck", cfg, tc, params=params, elastic=True,
                            device_profiles=SPEEDS, log=logs.append)
kept = RingSession.restore(f"{{tmp}}/stale_ck", cfg, tc, params=params, log=quiet)
res["stale"] = {{"after": [list(sp) for sp in fixed.backend.spans],
                "kept": [list(sp) for sp in kept.backend.spans], "log": [str(x) for x in logs]}}

# (d) the JAX package's own sessions: a straggler, a crash then a rejoin
def session(depth=DEPTH, **kw):
    logs = []
    tcd = dataclasses.replace(tc, initial_unfreeze_depth=depth)
    own = jax.tree.map(jnp.copy, params)          # a round donates its session's buffers
    return RingSession.create(cfg, tcd, params=own, log=logs.append, **kw), logs

def trace(sess, logs, n):
    hist = sess.run(n)
    return {{"rounds": [[bool(h.get("layout_changed")), h["survivors"], h["stage_times"],
                        int(h["boundary"]),
                        None if h.get("cache_hit") is None else bool(h["cache_hit"])]
                       for h in hist],
            "log": [str(x) for x in logs],
            "counts": [sess.backend.repartitions, sess.backend.shrinks]}}

def raised(fn):
    try:
        fn()
    except Exception as e:
        return [type(e).__name__, str(e)]

# (each round compiles for seconds here: the straggler to the round after its
# repartition, the churn to the round after the rejoin, at depth 5 alone)
res["straggler"] = trace(*session(backend="fused", spans=[4, 4, 3, 3], device_profiles=SPEEDS,
                                  elastic=True), 3)
res["rejoin"] = trace(*session(5, backend="cached", slots_per_epoch=2,
                               chaos=["2:crash:1", "5:join:1"], elastic=True), 6)
res["raises"] = {{"crash": raised(lambda: session(backend="fused", chaos="0:crash:2")[0].run(1)),
                 "join": raised(lambda: session(backend="fused", chaos="0:join:7",
                                                elastic=True)[0].run(1))}}
print(json.dumps(res))
"""


def _ref_layout_state(ex):
    """An executor's trainable set and optimizer state in the reference's layout."""
    return bridge.ring_state_to_reference(ex.stage_adapters(), ex.shared["head"], ex.opt_state,
                                          ex.cfg, ex.spans, ex.T)


def _assert_file_holds(path, params, opt):
    """The checkpoint ``path`` holds exactly ``params``' adapters and head and
    ``opt``, key for key, dtype for dtype, bit for bit."""
    want = {k: v for k, v in ckpt._flatten(params).items() if ckpt._key_filter(k, True)}
    want.update({f"{ckpt.OPT_NS}{ckpt.SEP}{k}": v for k, v in ckpt._flatten(opt).items()})
    data = np.load(path + ".npz")
    assert sorted(data.files) == sorted(want)
    for k, v in want.items():
        arr, _ = ckpt._stored(v)
        assert data[k].dtype == arr.dtype and np.array_equal(data[k], arr), k


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The port's states and checkpoints the JAX package reads (the three
    relayout cases before their shrink, a kill session saved after 8 rounds
    and its continuation, a session saved on a layout the fleet makes
    stale), then the JAX package's side in one 4-host-device subprocess: its
    shrinks and restores of those, and its own straggler, crash-and-rejoin
    and refused sessions."""
    tmp = tmp_path_factory.mktemp("jax_elastic")
    _, cfg = _configs()
    rng = np.random.default_rng(3)
    relayout = []
    for i, (_, layout, dead) in enumerate(SHRINK_CASES):
        ex = RingExecutor(cfg, _tc(), _params(), S, M, spans=layout)
        with torch.no_grad():
            for t in ex.trainable_tensors()[:-1]:
                t.copy_(torch.from_numpy(rng.standard_normal(t.shape)).to(t.dtype))
            ex.opt_state["count"].fill_(12)
        params, opt = _ref_layout_state(ex)
        ckpt.save(str(tmp / f"pre{i}"), params, opt_state=opt, adapters_only=True)
        ex.shrink(dead, profiles=[p for j, p in enumerate(partition.parse_device_profiles(SPEEDS))
                                  if j != dead])
        relayout.append(ex)
    logs = []
    kill = _session("fused", chaos="3:crash:2", elastic=True, log=logs.append)
    hist = kill.run(8)
    kill.save(str(tmp / "kill_ck"))
    saved = [t.clone() for t in tree_leaves(_ref_layout_state(kill.backend.driver))]
    cont = kill.run(3)
    stale = _session("fused")
    stale.run(2)
    stale.save(str(tmp / "stale_ck"))
    src = tmp / "params.npz"
    np.savez(src, **{f"leaf{i}": x for i, x in enumerate(jax.tree.leaves(_jax_params()))})
    code = _JAX_RUN.format(consts=repr((S, M, MB, SEQ, LAYERS, LR, DEPTH, SPEEDS,
                                        SHRINK_CASES)))
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={S}",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", code, str(src), str(tmp)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return {"jax": json.loads(run.stdout.strip().splitlines()[-1]), "tmp": tmp,
            "relayout": relayout, "kill": {"hist": hist, "logs": logs, "saved": saved,
                                           "cont": cont}}


@pytest.mark.parametrize("case", range(len(SHRINK_CASES)), ids=[c[0] for c in SHRINK_CASES])
def test_relayout_equals_jax_shrink(jax_run, case):
    """One state before the shrink (random adapters, head and moments, count
    12, in the reference's layout) loaded into both packages: after each
    package's ``shrink`` the spans, the adapters, the head, the stage-stacked
    moments and the count are the same, leaf for leaf, bit for bit."""
    ex = jax_run["relayout"][case]
    path = str(jax_run["tmp"] / f"post{case}")
    with open(path + ".json") as f:
        assert json.load(f)["extra"]["spans"] == _spans(ex.spans)
    _assert_file_holds(path, *_ref_layout_state(ex))


def test_kill_session_completes_and_resumes_bit_for_bit(jax_run):
    """Device 2 dies before round 3 of 8: training completes on the
    survivors with no checkpoint read, round 3 alone is marked, the
    checkpoint records the survivors at the original S0; the port's restore
    replays the membership and continues as the uninterrupted run, bit for
    bit; the JAX package restores the same file to the same survivors, spans
    and state, and its own save of it restores in the port and continues the
    same way; the resumed rounds are numbered 8, 9, 10 from the port's
    file and unnumbered from the JAX package's, which records no round
    count. Without ``elastic`` the crash raises, with the reference's
    message."""
    _, cfg = _configs()
    kill, ref, ref_raises = jax_run["kill"], jax_run["jax"]["kill"], jax_run["jax"]["raises"]
    hist, tmp = kill["hist"], jax_run["tmp"]
    assert [bool(h.get("layout_changed")) for h in hist] == [False] * 3 + [True] + [False] * 4
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["survivors"] == [0, 1, 3] and hist[-1]["round"] == 7
    with open(str(tmp / "kill_ck") + ".json") as f:
        ex = json.load(f)["extra"]
    assert (ex["survivors"], ex["n_stages"], ex["elastic"], ex["rounds"]) == ([0, 1, 3], 4, True,
                                                                             8)
    cont = [(h["loss"], h["losses"]) for h in kill["cont"]]
    # the port's checkpoint records its 8 rounds; the JAX package's records
    # none, and 27 steps over 4 then 3 stages do not say how many ran
    rounds = {"kill_ck": [8, 9, 10], "jax_kill_ck": [None] * 3}
    assert [h["round"] for h in kill["cont"]] == rounds["kill_ck"]
    for path in ("kill_ck", "jax_kill_ck"):
        back = RingSession.restore(str(tmp / path), cfg, _tc(), params=_params(), device="cpu",
                                   log=_quiet)
        assert back.backend.survivors == [0, 1, 3]
        assert _spans(back.backend.spans) == ex["spans"] == ref["spans"]
        params, opt = _ref_layout_state(back.backend.driver)
        for a, b in zip(tree_leaves((params, opt)), kill["saved"], strict=True):
            assert torch.equal(a, b), path
        again = back.run(3)
        assert [(h["loss"], h["losses"]) for h in again] == cont, path
        assert [h["round"] for h in again] == rounds[path], path
    assert (ref["survivors"], ref["S"], ref["step"], ref["shrinks"]) == ([0, 1, 3], 3, 27, 1)
    assert ref["format"] == RingSession.restore(str(tmp / "kill_ck"), cfg, _tc(), params=_params(),
                                                device="cpu", log=_quiet).backend.format
    got = _raises(lambda: _session("fused", chaos="0:crash:2").run(1))
    assert got is not None and list(got) == ref_raises["crash"] and "--elastic" in got[1]


def test_stale_layout_repaired_on_restore_as_jax(jax_run):
    """A checkpoint on the balanced 4:4:3:3 layout restored with ``elastic``
    and the fleet's speeds repartitions to 4:5:2:3 after the load and says
    so; without ``elastic`` the saved layout stays. The JAX package does the
    same with the same log line."""
    _, cfg = _configs()
    path, ref = str(jax_run["tmp"] / "stale_ck"), jax_run["jax"]["stale"]
    logs = []
    fixed = RingSession.restore(path, cfg, _tc(), params=_params(), device="cpu",
                                elastic=True, device_profiles=SPEEDS, log=logs.append)
    kept = RingSession.restore(path, cfg, _tc(), params=_params(), device="cpu", log=_quiet)
    assert _spans(fixed.backend.spans) == ref["after"] == [[0, 4], [4, 9], [9, 11], [11, 14]]
    assert _spans(kept.backend.spans) == ref["kept"] == [[0, 4], [4, 8], [8, 11], [11, 14]]
    assert [str(x) for x in logs] == ref["log"] and "stale" in logs[0]
    assert all(math.isfinite(h["loss"]) for h in fixed.run(2))


# ---------------------------------------------------------------- (d) sessions against JAX's


def _trace(hist, logs, be, ref):
    """What the sessions are held to, in the subprocess's form ``ref``: per
    round of ``ref``'s the mark, the survivors, the stage times, the
    boundary and the cache hit; the log lines; the repartitions and shrinks
    (every event has fired by ``ref``'s last round)."""
    return {"rounds": [[bool(h.get("layout_changed")), h["survivors"], h["stage_times"],
                        h["boundary"], h.get("cache_hit")] for h in hist[:len(ref["rounds"])]],
            "log": [str(x) for x in logs], "counts": [be.repartitions, be.shrinks]}


def test_straggler_session_repartitions_once_as_jax(jax_run):
    """Explicit 4:4:3:3 spans over the true speeds 1.0, 1.25, 0.5, 0.75: the
    detector's stage times trigger one repartition, to 4:5:2:3, at round 1,
    and the stage times are 4.0 after it; every mark, stage time, boundary,
    log line and count of rounds 0-2 is the JAX package's fused session's."""
    logs = []
    sess = _session("fused", spans=[4, 4, 3, 3], device_profiles=SPEEDS, elastic=True,
                    log=logs.append)
    hist = sess.run(8)
    be = sess.backend
    ref = jax_run["jax"]["straggler"]
    assert _trace(hist, logs, be, ref) == ref
    assert (be.repartitions, be.shrinks) == (1, 0)
    assert _spans(be.spans) == [[0, 4], [4, 9], [9, 11], [11, 14]]
    assert [bool(h.get("layout_changed")) for h in hist] == [False, True] + [False] * 6
    assert hist[-1]["stage_times"] == [4.0] * 4
    assert all(math.isfinite(h["loss"]) for h in hist)


@pytest.mark.parametrize("depth", [DEPTH, 5])
def test_crash_then_rejoin_equals_fresh_executors_and_jax(jax_run, depth):
    """A cached ring on 2 slots: device 1 crashes before round 2 and rejoins
    before round 5: sizes 4, 4, 3, 3, 3, 4, 4, 4; every round, before and
    after each change, equals a from-scratch direct executor at the live
    spans seeded with the state before the round (``torch.equal``: a graph or
    build of the old geometry would differ); the marks, survivors, stage
    times, boundaries, cache hits, log lines and counts of rounds 0-5 are
    the JAX package's cached session's at depth 5 (at depth 3 all but the
    boundaries, which fall from 11 to 10 at the crash and to 8 on the
    rejoin's 4:4:4:2 spans). At depth 5 the
    boundary falls from 8 to 5 at the crash and rises back to 8 at the
    rejoin (the new span edges), which the session and the executor accept
    on the round that moved the layout. A device never in the fleet cannot
    join, with the reference's message."""
    _, cfg = _configs()
    tc = _tc(depth)
    logs = []
    sess = _session("cached", tc=tc, slots_per_epoch=2, chaos=["2:crash:1", "5:join:1"],
                    elastic=True, log=logs.append)
    ex = sess.backend.driver
    hist = []
    for r in range(8):
        batch = sess.data.next()
        before, step = [t.clone() for t in ex.trainable_tensors()], ex.step
        m = sess.step(batch).materialize()
        hist.append(m.to_dict())
        rows = sess.backend.survivors
        twin = RingExecutor(cfg, tc, _params(), ex.S, M, spans=ex.spans)
        _copy_state(twin, before, step)
        want = twin.round(batch[1][rows], batch[2][rows])
        assert m.extras["losses"] == want["losses"].tolist(), r
        for i, (a, b) in enumerate(zip(ex.trainable_tensors(), twin.trainable_tensors(),
                                       strict=True)):
            assert torch.equal(a, b), (r, i)
    ref = jax_run["jax"]["rejoin"]
    if depth == 5:
        assert _trace(hist, logs, sess.backend, ref) == ref
    else:
        # the JAX session ran at depth 5: all but the boundaries is the same
        strip = lambda t: {**t, "rounds": [r[:3] + r[4:] for r in t["rounds"]]}
        assert strip(_trace(hist, logs, sess.backend, ref)) == strip(ref)
        assert [h["boundary"] for h in hist] == [11, 11, 10, 10, 10, 8, 8, 8]
    assert [len(h["survivors"]) for h in hist] == [4, 4, 3, 3, 3, 4, 4, 4]
    assert [h["cache_hit"] for h in hist] == [False] * 4 + [True, False, False, True]
    assert hist[-1]["survivors"] == [0, 1, 2, 3] and ex.S == 4
    if depth == 5:
        assert [h["boundary"] for h in hist] == [8, 8, 5, 5, 5, 8, 8, 8]
    bad = _raises(lambda: _session("fused", chaos="0:join:7", elastic=True).run(1))
    assert bad is not None and "original fleet" in bad[1]
    assert list(bad) == jax_run["jax"]["raises"]["join"]


# ---------------------------------------------------------------- (e) tenants


def test_tenant_isolation_survives_elastic_shrink():
    """A joint T = 3 cached ring on 2 slots loses device 3 before round 2:
    another stream for tenant 2 (seed 1234) leaves tenants 0 and 1 bit for
    bit unchanged through the shrink round and after; round 2 alone is
    marked; the survivors are [0, 1, 2] on 3 spans; the rebind drops every
    tenant's rows, so both slots recapture (hits F, F, F, F, T, T) and every
    tenant hits again."""
    T, rounds = 3, 6
    kw = dict(tenants=T, slots_per_epoch=2, chaos="2:crash:3", elastic=True)
    a, b = _session("cached", **kw), _session("cached", **kw)
    tc2 = dataclasses.replace(_tc(), seed=1234)
    b.data.rbs[2] = RingDataSource(_configs()[1], tc2, S, slots_per_epoch=2, tenants=T).rbs[2]
    ha, hb = a.run(rounds), b.run(rounds)
    per = lambda h, t: [x["tenant_losses"][t] for x in h]
    assert per(ha, 0) == per(hb, 0) and per(ha, 1) == per(hb, 1)
    assert per(ha, 2) != per(hb, 2)
    for h, sess in ((ha, a), (hb, b)):
        assert [bool(x.get("layout_changed")) for x in h] == [False, False, True] + [False] * 3
        assert h[-1]["survivors"] == [0, 1, 2] and len(sess.backend.spans) == 3
        assert [x["cache_hit"] for x in h] == [False] * 4 + [True, True]
        assert sess.backend.driver.tenant_hits == [2] * T


# ---------------------------------------------------------------- (f) the CLI

CLI = ["--mode", "ring", "--arch", "stablelm-3b", "--reduced", "--layers", "8", "--device", "cpu",
       "--microbatches", "2", "--batch-size", "1", "--seq-len", "16", "--unfreeze-interval", "8"]


def test_cli_chaos_elastic(capsys):
    """``--chaos 3:crash:2 --elastic``: the ``[elastic]`` line, round 3
    marked ``[elastic S=3]``, 6 rounds; without ``--elastic`` the crash
    raises naming it; ``--mode pjit`` refuses ``--chaos``."""
    train.main(CLI + ["--rounds", "6", "--chaos", "3:crash:2", "--elastic"])
    out = capsys.readouterr().out.splitlines()
    assert [ln for ln in out if ln.startswith("[elastic]")] == [
        "[elastic] device 2 crash at round 3: ring 4 -> 3 stages, spans [[0, 2], [2, 4], "
        "[4, 6], [6, 8]] -> [[0, 3], [3, 6], [6, 8]] (cache re-captures next round)"]
    rounds = [ln for ln in out if ln.startswith("round")]
    assert len(rounds) == 6 and rounds[3].endswith("[elastic S=3]")
    assert not any(ln.endswith("]") for i, ln in enumerate(rounds) if i != 3)
    last = json.loads(out[-1])
    assert last["survivors"] == [0, 1, 3] and last["round"] == 5
    with pytest.raises(RuntimeError, match="--elastic"):
        train.main(CLI + ["--rounds", "4", "--chaos", "3:crash:2"])
    with pytest.raises(SystemExit, match="ring-mode"):
        train.main(["--mode", "pjit", "--reduced", "--device", "cpu", "--steps", "1",
                    "--chaos", "1:crash:0"])
