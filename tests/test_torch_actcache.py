"""The port's frozen-trunk activation cache against the JAX package, on the CPU.

Reduced stablelm-3b (4 layers, d_model 128, d_ff 256) in f32, a ring of S =
4 stages (one layer a stage), M = 3 microbatches of 1 x 32 tokens per
client: the reference's own test grid (tests/test_actcache.py). The port
materialises the parameters from a seed and the bridge carries them to
JAX's layout; in numpy the adapters are then perturbed (W_up != 0) and wq,
wk, wv scaled to the fan-in init, as in tests/test_torch_ring.py (which says
why). On the CPU the port runs the plain versions of its kernels, and
``RingExecutor`` runs its rounds eagerly.

  (a) the port's and the JAX ``ActivationCache`` driven in lockstep with the
      same numpy entries, in every cache dtype: rows, free lists, ``stats()``
      and the entries read back equal; int8's stored values and scales bit
      for bit;
  (b) ``RingBatcher.next_slot`` and ``epoch`` bit for bit against the
      reference's, across epochs and re-instantiation;
  (c) ``pipeline_tick_counts(cached=True)`` against the JAX function;
  (d) the port's cached executor against its direct executor, bit for bit
      (losses and every tensor a round writes): over the reference's
      12-round, 2-slot walk across two boundary drops in ``native`` storage
      on the f32 model, and in every storage dtype on the model in bf16 over
      8 rounds and one drop (tests/test_packed.py's sweep). ``native``,
      ``f32`` and ``bf16`` entries of a bf16 model round-trip losslessly, so
      those stay bit for bit; ``int8`` is held at the reference's calibrated
      8e-2 (losses) and 2e-1 (parameters), and is not bit for bit;
  (e) against the JAX executor, on that walk and on the reference's bypass
      walk (tests/test_actcache.py): ``cache_hit``, ``stats()`` after every
      round, ``compile_counts()`` and the tick ledgers equal, each buffer row
      of a live key within 1e-5 of its largest entry of the JAX entry's
      stage-F slice, and the losses within 1e-5 relative. The JAX executor's
      head gradient is S times its oracle's (ROADMAP.md Queue 3), so both
      walk at lr 0, as tests/test_torch_executor.py walks it; the entries
      depend only on the frozen trunk, so lr 0 does not weaken the rows. The
      port stores stage F's input alone, ``[S_owner, M, mb, seq, D]``, where
      the reference stores every stage's shard: its bytes per entry are the
      reference's over S;
  (f) the CLI with ``--slots-per-epoch 2`` prints the hit pattern and the
      counts.

One 4-host-device JAX subprocess (XLA's optimisations off) runs the JAX
executor's two walks for the file.
"""
import functools
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._pytree import tree_leaves, tree_map  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import actcache as jax_actcache  # noqa: E402
from repro.core import pipeline as jax_pl  # noqa: E402
from repro.data import pipeline as jax_data  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import actcache  # noqa: E402
from repro_torch.core import partition  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core.executor import RingExecutor  # noqa: E402
from repro_torch.core.unfreeze import UnfreezeSchedule  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, M, MB, SEQ, LAYERS = 4, 3, 1, 32, 4
LR = 1e-3
RTOL_FWD = 1e-5          # the loss, relative
ROW_RTOL = 1e-5          # a buffer row, of its largest entry
INT8_TOL = (8e-2, 2e-1)  # (losses, parameters): tests/test_packed.py's calibration
WALK = 12                # rounds: boundaries 3, 2, 1, four rounds each
SWEEP = 8                # rounds: boundaries 3, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (tests/test_torch_executor.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype="float32"):
    kw = dict(n_layers=LAYERS, repeats=LAYERS, d_model=128, d_ff=256, dtype=dtype)
    return jax_get_config("stablelm-3b").reduced(**kw), get_config("stablelm-3b").reduced(**kw)


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The f32 parameters in JAX's layout (numpy leaves, read only), the
    adapters perturbed from a numpy seed and wq, wk, wv at the fan-in scale."""
    cfg, tcfg = _configs()
    p = bridge.params_to_jax(prm.materialize(tcfg, seed=0, device="cpu"), tcfg)
    rng = np.random.default_rng(1)
    (e,) = p["blocks"]
    ad = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(v.dtype)
          for k, v in e["adapter"].items()}
    fan_in = np.sqrt(cfg.n_heads / cfg.d_model)
    attn = {k: (v * fan_in).astype(v.dtype) if k in ("wq", "wk", "wv") else v
            for k, v in e["attn"].items()}
    return {**p, "blocks": ({**e, "adapter": ad, "attn": attn},)}


def _params(dtype="float32"):
    """The port's parameters: ``_jax_params`` carried back, each leaf in the
    dtype the ``dtype`` model gives it."""
    p = bridge.params_from_jax(_jax_params(), _configs()[1], device="cpu")
    like = prm.materialize(_configs(dtype)[1], seed=0, device="cpu")
    return tree_map(lambda t, r: t.to(r.dtype), p, like)


def _data(seed, seq=SEQ):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 512, (S, M, MB, seq)).astype(np.int32),
            rng.integers(0, 512, (S, M, MB, seq)).astype(np.int32))


BATCHES = (_data(10), _data(11))
SHORT = _data(12, seq=16)


def _tc(lr=LR, interval=4 * S):
    return TrainConfig(learning_rate=lr, unfreeze_interval=interval, n_microbatches=M,
                       batch_size=MB, seq_len=SEQ)


# ---------------------------------------------------------------- (a) the cache alone


class _Pair:
    """The port's and the JAX cache driven by the same calls."""

    def __init__(self, capacity, dtype, layout=None):
        self.dtype = dtype
        self.mine = actcache.ActivationCache(capacity, dtype=dtype, layout=layout)
        self.theirs = jax_actcache.ActivationCache(capacity, dtype=dtype, layout=layout)

    def call(self, name, *args, bf16=False):
        """Call ``name`` on both with numpy entries, hold the returns equal."""
        conv_m = lambda a: (torch.from_numpy(a).to(torch.bfloat16 if bf16 else torch.float32)
                            if isinstance(a, np.ndarray) else a)
        conv_t = lambda a: (jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)
                            if isinstance(a, np.ndarray) else a)
        got = getattr(self.mine, name)(*map(conv_m, args))
        want = getattr(self.theirs, name)(*map(conv_t, args))
        assert got == want, (name, args[:1], got, want)
        self.check()
        return got

    def check(self):
        mine, theirs = self.mine, self.theirs
        assert list(mine._rows.items()) == list(theirs._rows.items())
        assert mine._free == theirs._free
        assert mine.stats() == theirs.stats()
        assert (mine._buf is None) == (theirs._buf is None)
        if mine._buf is None:
            return
        assert tuple(mine.buffer.shape) == tuple(theirs.buffer.shape)
        for row in mine._rows.values():
            got = actcache.read_row(mine.buffer, mine.scales, row, self.dtype,
                                    torch.float32).numpy()
            s = None if theirs.scales is None else theirs.scales[row]
            want = np.asarray(jax_actcache.dequantize(theirs.buffer[row], s, self.dtype,
                                                      jnp.float32))
            np.testing.assert_array_equal(got, want)
            if self.dtype == "int8":
                np.testing.assert_array_equal(mine.buffer[row].numpy(),
                                              np.asarray(theirs.buffer[row]))
                np.testing.assert_array_equal(mine.scales[row].numpy(),
                                              np.asarray(theirs.scales[row]))


@pytest.mark.parametrize("dtype", actcache.CACHE_DTYPES)
def test_cache_walk_equals_jax(dtype):
    """LRU, overwrite, shape and dtype bypass, invalidate, invalidate_tenant,
    set_layout and rebind, call by call."""
    rng = np.random.default_rng(5)
    e = lambda shape=(2, 3, 8): (4 * rng.standard_normal(shape)).astype(np.float32)
    c = _Pair(2, dtype, layout=((0, 2), (2, 4)))
    c.check()
    assert c.call("compatible", (2, 3, 8))
    assert c.call("put", ("s0", 3), e())
    assert c.call("put", ("s1", 3), e())
    assert c.call("index_of", ("s0", 3)) is not None
    assert c.call("put", ("s2", 3), e())                 # evicts s1, the LRU entry
    assert c.call("index_of", ("s1", 3)) is None
    assert c.call("put", ("s0", 3), e())                 # overwrite in place
    assert not c.call("compatible", (4, 4))
    assert not c.call("put", ("s3", 3), e((4, 4)))       # shape bypass
    assert not c.mine.compatible((2, 3, 8), torch.bfloat16)
    assert not c.theirs.compatible((2, 3, 8), jnp.bfloat16)
    assert not c.call("put", ("s3", 3), e(), bf16=True)  # dtype bypass
    assert c.call("invalidate") == 2
    assert c.call("invalidate") == 0
    assert c.call("put", ("t0", 2), e())
    assert c.call("put", ("t1", 2), e())
    assert c.call("invalidate_tenant", "t0") == 1
    assert c.call("put", ("t2", 2), e())
    assert c.call("set_layout", ((0, 2), (2, 4))) == 0
    assert c.call("set_layout", ((0, 1), (1, 4))) == 2
    assert c.call("put", ("s0", 1), e())
    assert c.mine.rebind(layout=((0, 3), (3, 4))) == c.theirs.rebind(layout=((0, 3), (3, 4)))
    c.check()
    assert c.call("compatible", (4, 4))                  # no buffer: any shape fits
    assert c.call("put", ("s0", 1), e((4, 4)))
    assert c.call("index_of", ("s0", 1)) is not None
    assert c.mine.stats()["cache_invalidations"] == 4


def test_cache_capacity_zero_and_bad_arguments_equal_jax():
    c = _Pair(0, "native")
    assert not c.call("compatible", (2, 3))
    assert not c.call("put", ("s0", 3), np.ones((2, 3), np.float32))
    assert c.call("index_of", ("s0", 3)) is None
    assert c.call("invalidate") == 0
    assert c.mine.stats()["cache_bypasses"] == 1 and c.mine.stats()["cache_buffer_bytes"] == 0
    for cls in (actcache.ActivationCache, jax_actcache.ActivationCache):
        with pytest.raises(ValueError, match="capacity"):
            cls(-1)
        with pytest.raises(ValueError, match="dtype"):
            cls(2, dtype="fp8")


def test_int8_quantize_bit_equal_to_jax():
    """Against the reference's quantisation as its cache's writer runs it
    (under jit, where XLA turns the division by 127 into a product with the
    f32 reciprocal): per-row scales, round half to even (a row whose largest
    |x| is 127 has the scale 1, and puts x / s on the halves), the 1e-6 floor
    of an all-zero row, the clip; from f32 and from bf16."""
    rng = np.random.default_rng(6)
    x = (10 * rng.standard_normal((5, 7, 64))).astype(np.float32)
    x[0, 0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    x[0, 0, 6:] = 0.0
    x[0, 1] = 0.0
    x[1, 2, :] = 1e-9
    writer = jax.jit(lambda v: jax_actcache.quantize(v, "int8"))
    for src, jsrc in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        q, s = actcache.quantize(torch.from_numpy(x).to(src), "int8")
        jq, js = writer(jnp.asarray(x, jsrc))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        back = actcache.dequantize(q, s, "int8", torch.float32).numpy()
        np.testing.assert_array_equal(back, np.asarray(jax_actcache.dequantize(
            jq, js, "int8", jnp.float32)))
        if src == torch.float32:
            np.testing.assert_array_equal(q[0, 0, :6].numpy(), [127, 0, 2, 2, 0, -2])
            assert float(s[0, 1, 0]) == np.float32(1e-6) * np.float32(1 / 127)
    for dt in ("f32", "bf16", "native"):
        assert actcache.storage_dtype(dt, torch.bfloat16) == \
            {"f32": torch.float32, "bf16": torch.bfloat16, "native": torch.bfloat16}[dt]


# ---------------------------------------------------------------- (b) slotted batches


def test_ring_batcher_slots_equal_jax():
    kw = dict(vocab=512, n_per_client=40, seq=SEQ, seed=3)
    mine = data.RingBatcher(data.make_client_datasets(S, **kw), M, MB, seed=3,
                            slots_per_epoch=3)
    theirs = jax_data.RingBatcher(jax_data.make_client_datasets(S, **kw), M, MB, seed=3,
                                  slots_per_epoch=3)
    first = {}
    for i in range(8):
        if i % 3 == 1:                                   # next() draws move no slot
            for a, b in zip(mine.next(), theirs.next(), strict=True):
                np.testing.assert_array_equal(a, np.asarray(b))
        slot, t, lab = mine.next_slot()
        want = theirs.next_slot()
        assert slot == want[0] == i % 3 and mine.epoch == theirs.epoch == (i + 1) // 3
        np.testing.assert_array_equal(t, np.asarray(want[1]))
        np.testing.assert_array_equal(lab, np.asarray(want[2]))
        assert t.shape == (S, M, MB, SEQ) and t.dtype == np.int32
        if slot in first:
            np.testing.assert_array_equal(t, first[slot])
        first[slot] = t
    again = data.RingBatcher(data.make_client_datasets(S, **kw), M, MB, seed=3,
                             slots_per_epoch=3)
    for s in range(3):
        slot, t, _ = again.next_slot()
        np.testing.assert_array_equal(t, first[slot])
    assert again.epoch == 1
    with pytest.raises(ValueError, match="slots_per_epoch"):
        data.RingBatcher(again.ds, M, MB).next_slot()
    with pytest.raises(ValueError, match=">= 1"):
        data.RingBatcher(again.ds, M, MB, slots_per_epoch=0)
    assert data.RingBatcher(again.ds, M, MB).epoch == 0


# ---------------------------------------------------------------- (c) tick counts


@pytest.mark.parametrize("sizes", [(1, 1, 1, 1), (2, 2, 2, 2), (3, 2, 2, 1), (4, 5, 2, 3)])
def test_cached_tick_counts_equal_jax(sizes):
    spans = partition.normalize_spans(sizes)
    for n_micro in (1, 2, 4):
        for boundary in partition.span_boundaries(spans):
            for packed in (False, True):
                got = pl.pipeline_tick_counts(len(spans), n_micro, boundary, spans=spans,
                                              packed=packed, cached=True)
                assert got == jax_pl.pipeline_tick_counts(len(spans), n_micro, boundary,
                                                          spans=spans, packed=packed,
                                                          cached=True)
                F = got["frozen_stages"]
                assert got["fwd_ticks"] == got["bwd_ticks"] == n_micro + len(spans) - F - 1
                assert got["phase_a_round_ticks"] == got["phase_a_saved_ticks"] == 0


# ---------------------------------------------------------------- (d) cached against direct


def _state(ex):
    return [t.clone() for t in ex.trainable_tensors()]


def _walk(dtype, cache_dtype, rounds, lr=LR):
    """The cached executor and the direct one over ``rounds`` rounds of 2
    slots: per round the cached one's record, its losses and state, and the
    direct one's losses and state."""
    _, tcfg = _configs(dtype)
    cached = RingExecutor(tcfg, _tc(lr), _params(dtype), S, M, cache_capacity=2,
                          cache_dtype=cache_dtype)
    direct = RingExecutor(tcfg, _tc(lr), _params(dtype), S, M)
    out = []
    for r in range(rounds):
        t, lab = BATCHES[r % 2]
        got = cached.round(t, lab, slot=r % 2)
        want = direct.round(t, lab)
        assert got["boundary"] == want["boundary"]
        out.append((got, _state(cached), want["losses"], _state(direct)))
    return cached, direct, out


def _hold_bit_for_bit(walk):
    for r, (got, state, want, want_state) in enumerate(walk):
        assert torch.equal(got["losses"], want), (r, got["losses"], want)
        for i, (a, b) in enumerate(zip(state, want_state, strict=True)):
            assert torch.equal(a, b), f"round {r}: tensor {i} {tuple(a.shape)}"


def test_cached_walk_equals_direct_bit_for_bit():
    """f32, native storage, the reference's 12-round walk: capture, capture,
    hit, hit at boundaries 3, 2 and 1; two drops, each invalidating."""
    cached, direct, walk = _walk("float32", "native", WALK)
    _hold_bit_for_bit(walk)
    assert [w[0]["boundary"] for w in walk] == [3] * 4 + [2] * 4 + [1] * 4
    assert [w[0]["cache_hit"] for w in walk] == [False, False, True, True] * 3
    st = cached.cache.stats()
    assert (st["cache_hits"], st["cache_misses"], st["cache_invalidations"],
            st["cache_evictions"], st["cache_bypasses"]) == (6, 6, 2, 0, 0)
    assert st["cache_bytes_per_entry"] == S * M * MB * SEQ * 128 * 4
    assert cached.compile_counts() == {f"{b}/{m}": 1 for b in (1, 2, 3)
                                       for m in ("cached", "capture")}
    assert direct.compile_counts() == {f"{b}/direct": 1 for b in (1, 2, 3)}
    for b in (3, 2, 1):
        assert cached.measured_tick_ledger(b, "cached") == \
            pl.pipeline_tick_counts(S, M, b, 1, cached=True)
        assert cached.measured_tick_ledger(b, "capture") == \
            direct.measured_tick_ledger(b) == pl.pipeline_tick_counts(S, M, b, 1,
                                                                      packed=b >= 2)


@functools.lru_cache(maxsize=None)
def _bf16_direct():
    """The bf16 model's direct executor over the sweep: per round its losses,
    and its exported parameters at the end."""
    _, tcfg = _configs("bfloat16")
    ex = RingExecutor(tcfg, _tc(), _params("bfloat16"), S, M)
    losses = [ex.round(*BATCHES[r % 2])["losses"] for r in range(SWEEP)]
    return losses, _state(ex), ex.export_params()


@pytest.mark.parametrize("cache_dtype", actcache.CACHE_DTYPES)
def test_cache_dtypes_on_a_bf16_model(cache_dtype):
    want_losses, want_state, want_params = _bf16_direct()
    _, tcfg = _configs("bfloat16")
    ex = RingExecutor(tcfg, _tc(), _params("bfloat16"), S, M, cache_capacity=2,
                      cache_dtype=cache_dtype)
    recs = [ex.round(*BATCHES[r % 2], slot=r % 2) for r in range(SWEEP)]
    assert [r["cache_hit"] for r in recs] == [False, False, True, True] * 2
    assert [r["boundary"] for r in recs] == [3] * 4 + [2] * 4
    st = ex.cache.stats()
    assert (st["cache_hits"], st["cache_misses"], st["cache_invalidations"],
            st["cache_bypasses"], st["cache_dtype"]) == (4, 4, 1, 0, cache_dtype)
    n = S * M * MB * SEQ * 128
    f32_bytes = 4 * n
    assert st["cache_bytes_per_entry"] == {"native": n * 2, "f32": f32_bytes, "bf16": n * 2,
                                           "int8": n + 4 * n // 128}[cache_dtype]
    assert st["cache_bytes_per_entry"] < 0.3 * f32_bytes or cache_dtype != "int8"
    assert ex.compile_counts() == {f"{b}/{m}": 1 for b in (2, 3) for m in ("cached", "capture")}
    if cache_dtype != "int8":
        for r, (got, want) in enumerate(zip(recs, want_losses, strict=True)):
            assert torch.equal(got["losses"], want), (r, got["losses"], want)
        assert all(torch.equal(a, b) for a, b in zip(_state(ex), want_state, strict=True))
        return
    loss_err = max(float((r["losses"].float() - w.float()).abs().max())
                   for r, w in zip(recs, want_losses))
    got_params = ex.export_params()
    param_err = max(float((a.float() - b.float()).abs().max()) for a, b in
                    zip(tree_leaves(got_params), tree_leaves(want_params), strict=True))
    assert 0 < loss_err < INT8_TOL[0], loss_err        # lossy, and it tracks
    assert param_err < INT8_TOL[1], param_err


def test_bypass_and_slotless_rounds_run_direct():
    """slot=None, a batch that does not fit the buffer and capacity-1
    thrashing (the reference's bypass walk), each round equal to the direct
    executor's, bit for bit; a new batch shape builds ``direct`` anew."""
    _, tcfg = _configs()
    cached = RingExecutor(tcfg, _tc(interval=10 ** 6), _params(), S, M, cache_capacity=1)
    direct = RingExecutor(tcfg, _tc(interval=10 ** 6), _params(), S, M)
    for (t, lab), slot in zip(BYPASS_WALK_DATA(), BYPASS_SLOTS, strict=True):
        got = cached.round(t, lab, slot=slot)
        assert torch.equal(got["losses"], direct.round(t, lab)["losses"])
    assert all(torch.equal(a, b) for a, b in zip(_state(cached), _state(direct), strict=True))
    st = cached.cache.stats()
    assert (st["cache_hits"], st["cache_misses"], st["cache_evictions"],
            st["cache_bypasses"]) == (1, 3, 2, 1)
    assert cached.compile_counts() == {"3/cached": 1, "3/capture": 1, "3/direct": 2}


BYPASS_SLOTS = (None, 0, 1, 0, 3, 0)


def BYPASS_WALK_DATA():
    b0, b1 = BATCHES
    return (b0, b0, b1, b0, SHORT, b0)


@pytest.mark.parametrize("depth,packed", [(4, True), (2, False)])
def test_embeddings_and_per_owner_entries_equal_direct(depth, packed):
    """The entry's other sources: at F = 0 the capture writes the
    embeddings, with ``packed=False`` each owner's own Phase A; a capture
    and a hit of one slot, each equal to the direct round, bit for bit."""
    _, tcfg = _configs()
    sched = UnfreezeSchedule(depths=(depth,), interval=S)
    cached = RingExecutor(tcfg, _tc(), _params(), S, M, cache_capacity=1, packed=packed,
                          schedule=sched)
    direct = RingExecutor(tcfg, _tc(), _params(), S, M, packed=packed, schedule=sched)
    for hit in (False, True):
        got = cached.round(*BATCHES[0], slot=0)
        assert got["cache_hit"] == hit and got["boundary"] == LAYERS - depth
        assert torch.equal(got["losses"], direct.round(*BATCHES[0])["losses"])
        assert all(torch.equal(a, b) for a, b in zip(_state(cached), _state(direct),
                                                     strict=True))
    b = LAYERS - depth
    assert cached.measured_tick_ledger(b, "capture") == \
        pl.pipeline_tick_counts(S, M, b, 1, packed=packed and b >= 2)
    assert cached.measured_tick_ledger(b, "cached") == \
        pl.pipeline_tick_counts(S, M, b, 1, cached=True)
    if depth == LAYERS:                                 # F = 0: the row is the embeddings
        want = pl.gather_embeddings(tcfg, cached.shared, torch.from_numpy(BATCHES[0][0]).long())
        assert torch.equal(cached.cache.buffer[0], want)


def test_repartition_and_rebind_keep_the_cache_coherent():
    """A ring of 2 stages: ``repartition`` flushes the cache and keeps its
    buffer; after ``rebind`` (the buffer dropped) the next capture allocates
    anew; every round equals the direct executor's, bit for bit."""
    _, tcfg = _configs()
    make = lambda **kw: RingExecutor(tcfg, _tc(interval=10 ** 6), _params(), 2, M,
                                     spans=(2, 2), **kw)
    cached, direct = make(cache_capacity=2), make()

    def run(slot):
        t, lab = (x[:2] for x in BATCHES[slot])
        got = cached.round(t, lab, slot=slot)
        assert torch.equal(got["losses"], direct.round(t, lab)["losses"])
        return got

    assert [run(0)["cache_hit"] for _ in range(2)] == [False, True]
    buf = cached.cache.buffer
    for ex in (cached, direct):
        ex.repartition((3, 1))
    got = run(0)
    assert (got["cache_hit"], got["boundary"], got["cache_invalidations"]) == (False, 3, 1)
    assert cached.cache.buffer is buf and run(0)["cache_hit"]
    cached.cache.rebind(layout=cached.spans)
    assert not run(0)["cache_hit"] and cached.cache.buffer is not buf
    got = run(0)
    assert got["cache_hit"] and got["cache_invalidations"] == 2
    assert all(torch.equal(a, b) for a, b in zip(_state(cached), _state(direct), strict=True))


# ---------------------------------------------------------------- (e) against the JAX executor

_JAX_RUN = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_disable_most_optimizations", True)
from repro import compat
from repro.configs import TrainConfig, get_config
from repro.core.executor import RingExecutor
from repro.models import params as P

src, out = sys.argv[1], sys.argv[2]
S, M, MB, SEQ, LAYERS, WALK, BYPASS_SLOTS = {consts}
cfg = get_config("stablelm-3b").reduced(n_layers=LAYERS, repeats=LAYERS, d_model=128,
                                        d_ff=256, dtype="float32")
structure = jax.tree.structure(P.param_defs(cfg), is_leaf=lambda x: isinstance(x, P.PD))
arrays = np.load(src)
n_leaves = len([k for k in arrays.files if k.startswith("leaf")])
# a round donates its inputs, so each executor gets its own copy; made under the
# mesh, as the reference's tests make theirs (an array made outside it changes
# type after the first round, and the next round traces again)
fresh = lambda: jax.tree.map(jnp.copy, jax.tree.unflatten(
    structure, [jnp.asarray(arrays[f"leaf{{i}}"]) for i in range(n_leaves)]))
batches = [(jnp.asarray(arrays[f"tok{{k}}"]), jnp.asarray(arrays[f"lab{{k}}"])) for k in range(3)]
mesh = compat.make_mesh((S,), ("stage",))
res = {{}}

def record(tag, ex, m):
    res[f"{{tag}}/losses"] = np.asarray(m["losses"])
    res[f"{{tag}}/meta"] = np.asarray(json.dumps({{
        "hit": m["cache_hit"], "boundary": m["boundary"], "stats": ex.cache.stats(),
        "rows": [[list(k), r] for k, r in ex.cache._rows.items()]}}))
    if ex.cache._buf is not None:
        res[f"{{tag}}/buffer"] = np.asarray(ex.cache.buffer)

def ledgers(ex):
    return json.dumps({{f"{{b}}/{{mode}}": ex.measured_tick_ledger(b, mode)
                       for (b, mode) in ex._fns}})

with compat.set_mesh(mesh):
    tc = TrainConfig(learning_rate=0.0, unfreeze_interval=4 * S, n_microbatches=M,
                     batch_size=MB, seq_len=SEQ)
    ex = RingExecutor(cfg, tc, mesh, fresh(), S, M, cache_capacity=2)
    for r in range(WALK):
        t, l = batches[r % 2]
        record(f"walk/r{{r}}", ex, RingExecutor.materialize_metrics(ex.round(t, l, slot=r % 2)))
    res["walk/compile"] = np.asarray(json.dumps(ex.compile_counts()))
    res["walk/ledgers"] = np.asarray(ledgers(ex))

    tc = TrainConfig(learning_rate=0.0, unfreeze_interval=10 ** 6, n_microbatches=M,
                     batch_size=MB, seq_len=SEQ)
    ex = RingExecutor(cfg, tc, mesh, fresh(), S, M, cache_capacity=1)
    for r, (k, slot) in enumerate(zip((0, 0, 1, 0, 2, 0), BYPASS_SLOTS)):
        m = RingExecutor.materialize_metrics(ex.round(*batches[k], slot=slot))
        record(f"bypass/r{{r}}", ex, m)
    res["bypass/compile"] = np.asarray(json.dumps(ex.compile_counts()))
    res["bypass/ledgers"] = np.asarray(ledgers(ex))
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX executor's walk and bypass walk at lr 0, in a 4-host-device subprocess."""
    tmp = tmp_path_factory.mktemp("jax_actcache")
    src, out = tmp / "inputs.npz", tmp / "run.npz"
    leaves = jax.tree_util.tree_leaves(_jax_params())
    batches = {**{f"tok{k}": b[0] for k, b in enumerate((*BATCHES, SHORT))},
               **{f"lab{k}": b[1] for k, b in enumerate((*BATCHES, SHORT))}}
    np.savez(src, **{f"leaf{i}": x for i, x in enumerate(leaves)}, **batches)
    code = _JAX_RUN.format(consts=repr((S, M, MB, SEQ, LAYERS, WALK, BYPASS_SLOTS)))
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={S}",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", code, str(src), str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(out))


def _hold_to_jax(ref, tag, ex, rec):
    meta = json.loads(str(ref[f"{tag}/meta"]))
    assert rec["cache_hit"] == meta["hit"] and rec["boundary"] == meta["boundary"], tag
    want = dict(meta["stats"])
    for k in ("cache_bytes_per_entry", "cache_buffer_bytes"):
        assert want[k] % S == 0
        want[k] //= S                                   # the port stores stage F's shard alone
    assert ex.cache.stats() == want, tag
    rows = [[list(k), r] for k, r in ex.cache._rows.items()]
    assert rows == meta["rows"], tag
    for (slot, boundary), row in ex.cache._rows.items():
        theirs = ref[f"{tag}/buffer"][row][boundary]     # lps 1: F = boundary
        mine = ex.cache.buffer[row].numpy()
        scale = float(np.abs(theirs).max())
        assert float(np.abs(mine - theirs).max()) <= ROW_RTOL * scale, (tag, slot, boundary)
    losses = ref[f"{tag}/losses"]
    got = rec["losses"].numpy()
    assert np.all(np.abs(got - losses) <= RTOL_FWD * np.abs(losses)), (tag, got, losses)


def _hold_ledgers(ref, tag, ex):
    want = json.loads(str(ref[f"{tag}/ledgers"]))
    got = {f"{b}/{mode}": ex.measured_tick_ledger(b, mode) for (b, mode) in ex.tick_scan_lens}
    assert got == want


def test_walk_equals_jax_executor(jax_run):
    _, tcfg = _configs()
    ex = RingExecutor(tcfg, _tc(lr=0.0), _params(), S, M, cache_capacity=2)
    for r in range(WALK):
        _hold_to_jax(jax_run, f"walk/r{r}", ex, ex.round(*BATCHES[r % 2], slot=r % 2))
    assert ex.compile_counts() == json.loads(str(jax_run["walk/compile"]))
    _hold_ledgers(jax_run, "walk", ex)
    for b in (3, 2, 1):
        assert ex.measured_tick_ledger(b, "cached") == \
            pl.pipeline_tick_counts(S, M, b, 1, cached=True)


def test_bypass_walk_equals_jax_executor(jax_run):
    _, tcfg = _configs()
    ex = RingExecutor(tcfg, _tc(lr=0.0, interval=10 ** 6), _params(), S, M, cache_capacity=1)
    for r, ((t, lab), slot) in enumerate(zip(BYPASS_WALK_DATA(), BYPASS_SLOTS, strict=True)):
        _hold_to_jax(jax_run, f"bypass/r{r}", ex, ex.round(t, lab, slot=slot))
    assert ex.compile_counts() == json.loads(str(jax_run["bypass/compile"])) == \
        {"3/cached": 1, "3/capture": 1, "3/direct": 2}
    _hold_ledgers(jax_run, "bypass", ex)


# ---------------------------------------------------------------- (f) the CLI


def test_cached_ring_cli_on_the_cpu(capsys):
    train.main(["--mode", "ring", "--arch", "stablelm-3b", "--reduced", "--stages", "2",
                "--rounds", "8", "--unfreeze-interval", "8", "--slots-per-epoch", "2",
                "--microbatches", "2", "--batch-size", "1", "--seq-len", "16",
                "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    lines = [ln.split() for ln in out if ln.startswith("round")]
    assert [(ln[3], ln[-1]) for ln in lines] == \
        [("1", "False"), ("1", "False"), ("1", "True"), ("1", "True")] * 1 + \
        [("0", "False"), ("0", "False"), ("0", "True"), ("0", "True")]
    last = json.loads(out[-1])
    assert (last["cache_hits"], last["cache_misses"], last["cache_invalidations"],
            last["cache_capacity"], last["slot"]) == (4, 4, 1, 2, 1)
    train.main(["--mode", "ring", "--arch", "stablelm-3b", "--reduced", "--stages", "2",
                "--rounds", "2", "--slots-per-epoch", "2", "--cache-capacity", "1",
                "--microbatches", "1", "--batch-size", "1", "--seq-len", "8",
                "--cache-dtype", "int8", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("WARNING: cache_capacity 1 < slots_per_epoch 2")
    assert json.loads(out[-1])["cache_evictions"] == 1
    train.main(["--mode", "ring", "--trainer", "reference", "--arch", "stablelm-3b",
                "--reduced", "--stages", "2", "--rounds", "3", "--slots-per-epoch", "2",
                "--microbatches", "1", "--batch-size", "1", "--seq-len", "8",
                "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert "cache_hits" not in last and last["slot"] == 0
