"""The port's multi-tenant ring (one frozen trunk, T adapter sets) against
its own solo sessions and the JAX package's, on the CPU.

Reduced qwen2.5-3b in f32 with 8 layers, a ring of S = 4 stages (two layers
a stage), M = 2 microbatches of 2 x 8 tokens per client and tenant:
tests/test_tenants.py's shapes. Sessions run the port's seed weights, except
where they meet the JAX package: there the port's weights cross through the
bridge with the adapters perturbed in numpy (W_up != 0) and wq, wk, wv at the
fan-in scale (tests/test_torch_ring.py says why), and both packages run
them.

  (a) a joint T = 4 cached session equals 4 solo sessions, each fed
      ``RingDataSource(tenant=k)``, bit for bit (``torch.equal`` on every
      owner's loss, the tenant's mean, the adapters, the head and the
      moments), across a boundary drop and the cache's hits;
  (b) the joint round against the JAX package's, round for round: a T = 3
      cached session at lr 0 from the JAX executor's state before each
      round (4 rounds: capture, capture, hit, and a capture after the
      drop): every owner's loss and ``tenant_losses`` within 1e-5
      relative, the tick ledger (``T*S*M + F - 1`` packed; F = 1 per owner)
      and the per-tenant cache counts equal, the adapters equal, their
      moments within 5e-4 (m) and 1e-3 (v) of the leaf's largest entry. The
      JAX executor sums the head's gradient over its stages a second time
      (tests/test_torch_executor.py's docstring), so after the first round
      its head moments are S and S^2 times the port's, and at lr 0 that
      moves no parameter;
  (c) partitioned invalidation: after a warm T = 3 cache (hits [2, 2, 2]),
      a round trip of tenant 1 through an ``AdapterStore`` frees only its
      rows (one invalidation): hits [6, 4, 6] and misses [2, 4, 2] after 4
      more rounds, losses equal to an untouched control's;
  (d) isolation: another stream for tenant 2 leaves tenants 0 and 1 bit
      for bit unchanged;
  (e) the session flushes its lazy metrics before ``repartition``;
  (f) the joint and ``tenant=k`` data sources give the JAX package's
      arrays, slots and cursors;
  (g) an ``AdapterStore`` bundle and a ``/T3`` session checkpoint written by
      the port restore in the JAX package, and the reverse, bit for bit;
  (h) the CLI: ``--tenants 2 --adapter-store DIR`` trains and exports, and
      the serve CLI serves the trunk and both tenants from DIR;
  and the tenant-stacked layout: ``stack_entry``/``unstack_entry(leading=1)``
  equal the JAX package's on uniform and ragged spans, and a session's
  checkpoint state goes back to the executor's tensors exactly.

The JAX ring runs on four host devices, so its sessions run once for the
file in one subprocess (XLA's optimisations off).
"""
import dataclasses
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

from repro.api import AdapterStore as JaxAdapterStore  # noqa: E402
from repro.api.data import RingDataSource as JaxRingDataSource  # noqa: E402
from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import AdapterStore, IntervalPolicy, RingSession  # noqa: E402
from repro_torch.api.data import RingDataSource  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, M, MB, SEQ, LAYERS = 4, 2, 2, 8, 8
LR = 1e-3
RTOL_FWD = 1e-5          # the loss, relative
RTOL_STATE = 5e-4        # moments: of the leaf's largest entry (v twice that)
DEPTH = 4                # boundary 4: F = 2, the packed conveyor
JAX_T, JAX_SLOTS, JAX_ROUNDS = 3, 2, 4
JAX_INTERVAL = 3 * S     # rounds 0-2 at boundary 4, round 3 at 3 -> 2 (F = 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (tests/test_torch_executor.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    kw = dict(n_layers=LAYERS, repeats=LAYERS)
    return (dataclasses.replace(jax_get_config("qwen2.5-3b").reduced(**kw), dtype="float32"),
            dataclasses.replace(get_config("qwen2.5-3b").reduced(**kw), dtype="float32"))


def _tc(interval=10**6, lr=LR):
    return TrainConfig(seed=0, learning_rate=lr, warmup_steps=1, unfreeze_interval=interval,
                       initial_unfreeze_depth=DEPTH, n_stages=S, n_microbatches=M,
                       batch_size=MB, seq_len=SEQ)


def _session(backend="fused", tc=None, **kw):
    kw = {"n_stages": S, "device": "cpu", "log": lambda *a: None, **kw}
    return RingSession.create(_configs()[1], tc or _tc(), backend=backend, **kw)


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The port's seed weights in JAX's layout (numpy leaves, read only), the
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


def _params():
    return bridge.params_from_jax(_jax_params(), _configs()[1], device="cpu")


def _equal_trees(a, b, what=""):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), what


def _np_flat(tree):
    """``{key path: numpy array}`` of a tree (tensors or JAX arrays), bf16 as bits."""
    out = {}
    for k, v in ckpt._flatten(tree).items():
        v = bridge.to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)
        out[k] = v.view(np.int16) if v.dtype.name == "bfloat16" else v
    return out


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err:.3g} > {rtol} x {scale:.3g}"


def _recorded(sess):
    """The executor's round records of ``sess`` (device tensors), as it runs."""
    ex, recs = sess.backend.driver, []
    real = ex.round
    ex.round = lambda *a, **kw: (recs.append(real(*a, **kw)), recs[-1])[1]
    return recs


# ---------------------------------------------------------------- (a) joint = solo


def test_joint_session_equals_solo_sessions_bit_for_bit():
    """A joint T = 4 cached session over 6 rounds (boundaries 4, 4, 2, 2, 2,
    2: captures, the drop's invalidation, hits at rounds 4 and 5) against 4
    solo cached sessions on 2 slots, solo k fed tenant k's stream: each
    owner's loss, the tenant's mean, and then the adapters, the head and
    their moments, ``torch.equal``."""
    T, rounds = 4, 6
    tc = _tc(interval=2 * S)
    joint = _session("cached", tc, tenants=T, slots_per_epoch=2)
    assert joint.backend.driver.cache.capacity == 2 * T
    recs = _recorded(joint)
    hist = [joint.step().materialize() for _ in range(rounds)]
    assert [m.boundary for m in hist] == [4, 4, 2, 2, 2, 2]
    assert [m.cache_hit for m in hist] == [False] * 4 + [True] * 2
    assert hist[-1].cache["tenant_cache_hits"] == [2] * T
    assert hist[-1].cache["tenant_cache_misses"] == [4] * T
    for t in range(T):
        solo = _session("cached", tc, slots_per_epoch=2)
        solo.data = RingDataSource(_configs()[1], tc, S, slots_per_epoch=2, tenant=t)
        for r, rec in enumerate(recs):
            m = solo.step()
            assert torch.equal(m.extras["losses"], rec["tenant_owner_losses"][:, t]), (t, r)
            assert torch.equal(m.loss, rec["tenant_losses"][t]), (t, r)
            assert (m.boundary, m.cache_hit) == (rec["boundary"], rec["cache_hit"])
        _equal_trees(joint.export_adapters(tenant=t), solo.export_adapters(), f"tenant {t}")
        _equal_trees(joint.tenants[t].export_opt(), solo.tenants[0].export_opt(),
                     f"tenant {t} moments")
    assert len(set(hist[-1].extras["tenant_losses"])) == T      # distinct streams
    # the mean over [S, T], each owner's mean over the tenants
    grid = recs[-1]["tenant_owner_losses"]
    assert torch.equal(recs[-1]["loss"], grid.mean())
    assert torch.equal(recs[-1]["losses"], grid.mean(dim=1))


# ---------------------------------------------------------------- (c), (d), (e)


def test_tenant_invalidation_leaves_the_others_hits(tmp_path):
    """A warm T = 3 cache (capture, capture, hit, hit); tenant 1 through an
    AdapterStore and back frees only its rows; the next 4 rounds re-capture
    tenant 1 while 0 and 2 hit; the losses are an untouched control's."""
    T = 3
    sess = _session("cached", tenants=T, slots_per_epoch=2)
    ctrl = _session("cached", tenants=T, slots_per_epoch=2)
    h1 = sess.run(4)
    assert (h1[-1]["tenant_cache_hits"], h1[-1]["tenant_cache_misses"]) == ([2] * T, [2] * T)
    store = AdapterStore(str(tmp_path / "adstore"))
    sess.tenants[1].save_to(store, "t1")
    sess.tenants[1].load_from(store, "t1")      # the same values; frees tenant 1's rows
    assert sess.backend.driver.cache.invalidations == 1 and store.has_opt("t1")
    assert store.names() == ["t1"] and "t1" in store
    h2 = sess.run(4)
    assert h2[-1]["tenant_cache_hits"] == [6, 4, 6]
    assert h2[-1]["tenant_cache_misses"] == [2, 4, 2]
    m = sess.step().materialize()
    group = sess.tenants[1].metrics(m)
    assert group["loss"] == m.extras["tenant_losses"][1] and group["cache_hits"] == 5
    hc = ctrl.run(9)
    assert [h["loss"] for h in h1 + h2] + [m.loss] == [h["loss"] for h in hc]


def _bump_rows(tree, index):
    """A copy of ``tree`` with 1 added at ``index`` of every leaf."""
    tree = tree_map(lambda x: x.clone(), tree)
    for x in tree_leaves(tree):
        x[index] += 1.0
    return tree


def test_imports_that_split_the_frozen_trunk_are_refused():
    """At boundary 4 (stages 0 and 1 frozen: repeats 0-3) a bundle whose
    frozen row differs from the other tenant's is refused, into tenant 0 as
    into tenant 1, and so is a checkpoint whose tenants differ there; a
    refused import changes nothing. A row above the boundary may differ: it
    is imported and frees only that tenant's cache rows."""
    sess = _session("cached", tenants=2, slots_per_epoch=2)
    sess.run(1)
    d = sess.backend.driver
    before = [x.clone() for x in d.trainable_tensors()]
    bundle = sess.export_adapters(tenant=1)
    split = {**bundle, "adapter": _bump_rows(bundle["adapter"], 0)}
    for t in (0, 1):
        with pytest.raises(ValueError, match="differ in the 2 stage"):
            d.import_adapters(t, split)
    st = sess.backend.state()
    params = {**st["params"], "blocks": ({"adapter": _bump_rows(
        st["params"]["blocks"][0]["adapter"], (1, 3))},)}
    with pytest.raises(ValueError, match="differ in the 2 stage"):
        sess.backend.load_state(params, st["opt"], step=sess.step_count)
    assert all(torch.equal(a, b) for a, b in zip(d.trainable_tensors(), before))
    assert d.cache.invalidations == 0
    above = {**bundle, "adapter": _bump_rows(bundle["adapter"], LAYERS - 1)}
    d.import_adapters(1, above)
    _equal_trees(sess.export_adapters(tenant=1), above, "tenant 1 after the import")
    assert d.cache.invalidations == 1 and len(d.cache) == 1


def test_tenant_isolation():
    """Another stream for tenant 2 (seed 1234): tenants 0 and 1 lose the same
    bits every round, tenant 2 does not."""
    T, rounds = 3, 3
    a = _session("fused", tenants=T)
    b = _session("fused", tenants=T)
    tc2 = dataclasses.replace(_tc(), seed=1234)
    b.data.rbs[2] = RingDataSource(_configs()[1], tc2, S, tenants=T).rbs[2]
    ha, hb = a.run(rounds), b.run(rounds)
    per = lambda h, t: [x["tenant_losses"][t] for x in h]
    assert per(ha, 0) == per(hb, 0) and per(ha, 1) == per(hb, 1)
    assert per(ha, 2) != per(hb, 2)


def test_metrics_flushed_before_repartition():
    """A lazy RoundMetrics held across ``repartition`` is materialized first
    (equal to a control read at once), and the next round on [3, 1, 2, 2]
    (the span edge at 4 stays, so the boundary does) equals the control's on
    the old layout."""
    T = 2
    sess = _session("fused", tenants=T)
    ctrl = _session("fused", tenants=T)
    m = sess.step()
    mc = ctrl.step().materialize()
    assert not m.materialized
    sess.repartition([3, 1, 2, 2])
    assert m.materialized and m.loss == mc.loss
    assert m.extras["tenant_losses"] == mc.extras["tenant_losses"]
    assert [list(sp) for sp in sess.backend.spans] == [[0, 3], [3, 4], [4, 6], [6, 8]]
    assert sess.backend.format == "ring/S4/spans3-1-2-2/T2"
    nxt, want = sess.step().materialize(), ctrl.step().materialize()
    assert abs(nxt.loss - want.loss) <= RTOL_FWD * abs(want.loss)


# ---------------------------------------------------------------- (f) data


def test_tenant_data_equals_jax():
    """The joint source's [S, T, M, mb, seq] batches and shared slot, each
    ``tenant=k`` source's, and their cursors are the JAX package's."""
    jcfg, tcfg = _configs()
    T = 3
    jtc = JaxTrainConfig(seed=3, n_microbatches=M, batch_size=MB, seq_len=SEQ)
    tc = TrainConfig(seed=3, n_microbatches=M, batch_size=MB, seq_len=SEQ)
    for slots in (2, None):
        pairs = [(RingDataSource(tcfg, tc, S, slots_per_epoch=slots, tenants=T),
                  JaxRingDataSource(jcfg, jtc, S, slots_per_epoch=slots, tenants=T))]
        pairs += [(RingDataSource(tcfg, tc, S, slots_per_epoch=slots, tenant=k),
                   JaxRingDataSource(jcfg, jtc, S, slots_per_epoch=slots, tenant=k))
                  for k in range(T)]
        joint = []
        for mine, theirs in pairs:
            got = [mine.next() for _ in range(3)]
            for (slot, tok, lab), (wslot, wtok, wlab) in zip(got, [theirs.next()
                                                                   for _ in range(3)]):
                assert slot == wslot
                np.testing.assert_array_equal(tok, wtok)
                np.testing.assert_array_equal(lab, wlab)
            assert json.dumps(mine.state()) == json.dumps(theirs.state())
            joint.append(got)
        assert joint[0][0][1].shape == (S, T, M, MB, SEQ)
        for k in range(T):                  # tenant k's slice is the tenant=k source's
            for (_, tok, _), (_, tk, _) in zip(joint[0], joint[1 + k]):
                np.testing.assert_array_equal(tok[:, k], tk)
        # a cursor moves between the packages
        mine = RingDataSource(tcfg, tc, S, slots_per_epoch=slots, tenants=T)
        mine.load_state(pairs[0][1].state())
        want, got = pairs[0][1].next(), mine.next()
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="data cursor of 1 tenants"):
        RingDataSource(tcfg, tc, S, tenants=T).load_state(RingDataSource(tcfg, tc, S).state())


# ---------------------------------------------------------------- the tenant-stacked layout


@pytest.mark.parametrize("sizes", [(2, 2, 2, 2), (3, 1, 2, 2)])
def test_tenant_stacked_layout_equals_jax(sizes):
    """``stack_entry``/``unstack_entry(leading=1)`` on tenant-major
    ``[T, R, C, ...]`` trees equal the JAX package's, uniform and ragged, and
    a T = 2 session's checkpoint state (the reference's tenant-stacked
    layout) goes back to the executor's tensors exactly."""
    from repro.core import pipeline as jax_pl
    spans = pl.resolve_spans(LAYERS, S, list(sizes))
    rng = np.random.default_rng(4)
    tree = {"w": rng.standard_normal((3, LAYERS, 1, 5)).astype(np.float32)}
    want = jax_pl.stack_entry(tree, spans, leading=1)
    got = pl.stack_entry({"w": torch.from_numpy(tree["w"])}, spans, leading=1)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    back = pl.unstack_entry(got, spans, leading=1)
    np.testing.assert_array_equal(back["w"].numpy(), tree["w"])
    np.testing.assert_array_equal(
        back["w"].numpy(), np.asarray(jax_pl.unstack_entry(want, spans, leading=1)["w"]))
    sess = _session("fused", tenants=2, spans=list(sizes))
    sess.step()
    be, ex = sess.backend, sess.backend.driver
    st = be.state()
    assert st["params"]["blocks"][0]["adapter"]["w_up"].shape == (2, LAYERS, 1, 16, 256)
    assert st["opt"]["m"]["adapter"]["w_up"].shape == (S, 2, max(sizes), 1, 16, 256)
    stage_adapters, head, opt = bridge.ring_state_from_reference(st["params"], st["opt"],
                                                                 be.cfg, be.spans, 2)
    _equal_trees((stage_adapters, head, opt),
                 (ex.stage_adapters(), ex.shared["head"], ex.opt_state), "round trip")


# ---------------------------------------------------------------- (g) bundles


def _jax_like(tree):
    return jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32 if t.is_floating_point()
                                            else jnp.int32), tree)


def test_bundles_cross_between_the_packages(tmp_path):
    """A tenant's bundle (adapters, head and moments) written by the port's
    AdapterStore reads in the JAX package's bit for bit, and the reverse."""
    sess = _session("fused", tenants=2)
    sess.step()
    bundle, opt = sess.export_adapters(tenant=1), sess.tenants[1].export_opt()
    assert bundle["adapter"]["w_down"].shape == (LAYERS, 1, 256, 16)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    sess.tenants[1].save_to(AdapterStore(port_dir), "t1", meta={"note": "x"})
    jstore = JaxAdapterStore(port_dir)
    got, meta = jstore.get("t1", _jax_like(bundle))
    assert meta["extra"] == {"format": "AdapterStore/v1", "tenant": 1, "note": "x"}
    assert meta["step"] == S and jstore.has_opt("t1")
    assert _np_flat(got).keys() == _np_flat(bundle).keys()
    for k, v in _np_flat(bundle).items():
        np.testing.assert_array_equal(_np_flat(got)[k], v, err_msg=k)
    jopt = jstore.get_opt("t1", _jax_like(opt))
    for k, v in _np_flat(opt).items():
        np.testing.assert_array_equal(_np_flat(jopt)[k], v, err_msg=k)
    # the reverse: JAX writes tenant 1's set, the port reads it into tenant 0
    to_jax = lambda tree: jax.tree.map(lambda t: jnp.asarray(bridge.to_numpy(t)), tree)
    JaxAdapterStore(jax_dir).put("t1", to_jax(bundle), opt=to_jax(opt), step=8)
    store = AdapterStore(jax_dir)
    back, meta = store.get("t1", sess.export_adapters(tenant=0))
    assert meta["step"] == 8
    _equal_trees(back, bundle, "JAX bundle")
    sess.tenants[0].load_from(store, "t1")
    _equal_trees(sess.export_adapters(tenant=0), bundle, "loaded into tenant 0")
    got_opt = sess.tenants[0].export_opt()
    _equal_trees({k: got_opt[k] for k in ("m", "v")}, {k: opt[k] for k in ("m", "v")})
    with pytest.raises(ValueError, match="exactly the keys"):
        store.put("bad", {"adapter": bundle["adapter"]})


# ---------------------------------------------------------------- (b), (g): the JAX sessions

_JAX_RUN = r"""
import json, sys
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_disable_most_optimizations", True)
from repro.api import IntervalPolicy, RingSession
from repro.configs import TrainConfig, get_config
from repro.models import params as P

src, out, port_ck, jax_ck = sys.argv[1:5]
S, M, MB, SEQ, LAYERS, T, SLOTS, ROUNDS, DEPTH, INTERVAL, LR = {consts}
cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(n_layers=LAYERS, repeats=LAYERS),
                          dtype="float32")
structure = jax.tree.structure(P.param_defs(cfg), is_leaf=lambda x: isinstance(x, P.PD))
arrays = np.load(src)
params = jax.tree.unflatten(structure,
                            [jnp.asarray(arrays[f"leaf{{i}}"]) for i in range(len(arrays.files))])
tc = lambda lr: TrainConfig(seed=0, learning_rate=lr, n_stages=S, n_microbatches=M,
                            batch_size=MB, seq_len=SEQ)
policy = lambda: IntervalPolicy(initial_depth=DEPTH, interval=INTERVAL)
quiet = lambda *a: None
res = {{}}

def dump(tag, sess):
    st = sess.backend.state()
    (e,) = st["params"]["blocks"]
    for k, v in e["adapter"].items():
        res[f"{{tag}}/params::blocks::0::adapter::{{k}}"] = np.asarray(v)
    for k, v in st["params"]["head"].items():
        res[f"{{tag}}/params::head::{{k}}"] = np.asarray(v)
    for name in ("m", "v"):
        for part in ("adapter", "head"):
            for k, v in st["opt"][name][part].items():
                res[f"{{tag}}/opt::{{name}}::{{part}}::{{k}}"] = np.asarray(v)
    res[f"{{tag}}/opt::count"] = np.asarray(st["opt"]["count"])

# the port's /T checkpoint, restored here
back = RingSession.restore(port_ck, cfg, tc(LR), policy=policy(), params=params, log=quiet)
dump("port", back)
res["port/format"] = np.asarray(back.backend.format)
res["port/step"] = np.asarray(back.step_count)
res["port/data"] = np.asarray(json.dumps(back.data.state()))
del back

# the joint cached session at lr 0
sess = RingSession.create(cfg, tc(0.0), backend="cached", n_stages=S, tenants=T,
                          slots_per_epoch=SLOTS, policy=policy(), params=params, log=quiet)
ex = sess.backend.driver
dump("start", sess)
for r in range(ROUNDS):
    slot, tokens, labels = sess.data.next()
    m = sess.step((slot, tokens, labels)).materialize()
    mode = "cached" if m.cache_hit else "capture"
    res[f"r{{r}}/slot"], res[f"r{{r}}/tokens"], res[f"r{{r}}/labels"] = slot, tokens, labels
    res[f"r{{r}}/losses"] = np.asarray(m.extras["losses"])
    res[f"r{{r}}/tenant_losses"] = np.asarray(m.extras["tenant_losses"])
    res[f"r{{r}}/loss"] = np.asarray(m.loss)
    res[f"r{{r}}/boundary"] = np.asarray(m.boundary)
    res[f"r{{r}}/mode"] = np.asarray(mode)
    res[f"r{{r}}/ledger"] = np.asarray(json.dumps(ex.measured_tick_ledger(m.boundary, mode)))
    res[f"r{{r}}/hits"] = np.asarray(m.cache["tenant_cache_hits"])
    res[f"r{{r}}/misses"] = np.asarray(m.cache["tenant_cache_misses"])
    dump(f"r{{r}}", sess)
res["compile"] = np.asarray(json.dumps(ex.compile_counts()))
sess.save(jax_ck)
res["jax/format"] = np.asarray(sess.backend.format)
_, res["next/tokens"], _ = sess.data.next()
np.savez(out, **res)
"""


def _ref_state(ref, tag):
    """A dumped JAX session state as ``{key path: array}`` (the checkpoint's keys)."""
    return {k[len(tag) + 1:]: v for k, v in ref.items()
            if k.startswith(tag + "/") and "::" in k}


def _unflatten(flat, like, prefix=""):
    """``flat``'s ``{key path: array}`` as tensors in ``like``'s structure."""
    if isinstance(like, dict):
        return {k: _unflatten(flat, v, f"{prefix}{k}::") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(flat, v, f"{prefix}{i}::") for i, v in enumerate(like))
    return bridge.to_tensor(flat[prefix[:-2]], "cpu").to(like.dtype).reshape(like.shape)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A port T = 3 fused session saved after one round (the file the JAX
    package restores), then the JAX sessions in one 4-host-device
    subprocess."""
    tmp = tmp_path_factory.mktemp("jax_tenants")
    port_ck, jax_ck = str(tmp / "port_ck"), str(tmp / "jax_ck")
    sess = _session("fused", _tc(), tenants=JAX_T, params=_params(),
                    policy=IntervalPolicy(initial_depth=DEPTH, interval=JAX_INTERVAL))
    sess.step()
    sess.save(port_ck)
    src, out = tmp / "params.npz", tmp / "run.npz"
    np.savez(src, **{f"leaf{i}": x for i, x in enumerate(jax.tree.leaves(_jax_params()))})
    code = _JAX_RUN.format(consts=repr((S, M, MB, SEQ, LAYERS, JAX_T, JAX_SLOTS, JAX_ROUNDS,
                                        DEPTH, JAX_INTERVAL, LR)))
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={S}",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", code, str(src), str(out), port_ck, jax_ck],
                         env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    st = sess.backend.state()
    return {"jax": dict(np.load(out)), "jax_ck": jax_ck,
            "port": _np_flat({"params": st["params"], "opt": st["opt"]}),
            "port_format": st["format"], "port_data": sess.data.state()}


def test_joint_round_matches_jax_round_for_round(jax_run):
    """T = 3 at lr 0, each round from the JAX session's state before it:
    slots 0, 1, 0, 1 (capture, capture, hit; then the drop to boundary 2 and
    a capture on the per-owner Phase A): each owner's loss and each
    tenant's, the tick ledger, the per-tenant cache counts, the adapters,
    their moments, the step count, the builds."""
    ref = jax_run["jax"]
    sess = _session("cached", _tc(lr=0.0), tenants=JAX_T, slots_per_epoch=JAX_SLOTS,
                    params=_params(),
                    policy=IntervalPolicy(initial_depth=DEPTH, interval=JAX_INTERVAL))
    be, ex = sess.backend, sess.backend.driver
    packed_ticks = JAX_T * S * M + 2 - 1            # T*S*M + F - 1 at F = 2
    for r in range(JAX_ROUNDS):
        begin = _ref_state(ref, "start" if r == 0 else f"r{r - 1}")
        like = be.state()
        # the JAX state into the executor's tensors (the cache keeps its rows)
        stage_adapters, head, opt = bridge.ring_state_from_reference(
            _unflatten(begin, {"params": like["params"]})["params"],
            _unflatten(begin, {"opt": like["opt"]})["opt"], be.cfg, be.spans, JAX_T)
        bridge.copy_into(ex.stage_adapters(), stage_adapters)
        bridge.copy_into(ex.shared["head"], head)
        bridge.copy_into(ex.opt_state, opt)
        slot, tokens, labels = sess.data.next()
        assert slot == int(ref[f"r{r}/slot"]) == r % JAX_SLOTS
        np.testing.assert_array_equal(tokens, ref[f"r{r}/tokens"])
        np.testing.assert_array_equal(labels, ref[f"r{r}/labels"])
        m = sess.step((slot, tokens, labels)).materialize()
        boundary, mode = int(ref[f"r{r}/boundary"]), str(ref[f"r{r}/mode"])
        assert (m.boundary, mode) == ((4, "capture"), (4, "capture"), (4, "cached"),
                                      (2, "capture"))[r]
        assert m.cache_hit == (mode == "cached") and m.step == S * (r + 1)
        _close(m.extras["losses"], ref[f"r{r}/losses"], RTOL_FWD, f"round {r} losses")
        _close(m.extras["tenant_losses"], ref[f"r{r}/tenant_losses"], RTOL_FWD,
               f"round {r} tenant losses")
        _close(m.loss, ref[f"r{r}/loss"], RTOL_FWD, f"round {r} loss")
        ledger = ex.measured_tick_ledger(boundary, mode)
        assert ledger == json.loads(str(ref[f"r{r}/ledger"]))
        assert ledger["phase_a_round_ticks"] == (packed_ticks, packed_ticks, 0, S * M)[r]
        assert m.cache["tenant_cache_hits"] == ref[f"r{r}/hits"].tolist() == \
            [(0, 0, 1, 1)[r]] * JAX_T
        assert m.cache["tenant_cache_misses"] == ref[f"r{r}/misses"].tolist() == \
            [(1, 2, 2, 3)[r]] * JAX_T
        st = be.state()
        got, end = _np_flat({"params": st["params"], "opt": st["opt"]}), \
            _ref_state(ref, f"r{r}")
        assert got.keys() == end.keys()
        for k, v in end.items():
            if k.startswith("params::"):
                np.testing.assert_array_equal(got[k], v, err_msg=k)     # lr 0: unmoved
            elif "::adapter::" in k:
                _close(got[k], v, RTOL_STATE * (2 if "::v::" in k else 1), f"round {r} {k}")
            elif k == "opt::count":
                assert int(got[k]) == int(v) == S * (r + 1)
        if r == 0:
            for name, power in (("m", 1), ("v", 2)):
                k = f"opt::{name}::head::w"
                mine = got[k]
                big = np.abs(mine) > 1e-3 * np.abs(mine).max()
                assert abs(np.median(end[k][big] / mine[big]) / S ** power - 1) < 1e-3, k
    # the same (boundary, mode) rounds built; the JAX executor traced boundary
    # 4's capture twice at T = 3, a retrace with no counterpart in a build
    assert ex.compile_counts() == {"2/capture": 1, "4/cached": 1, "4/capture": 1}
    assert ex.compile_counts().keys() == json.loads(str(ref["compile"])).keys()


def test_jax_restores_a_port_tenant_checkpoint_bit_for_bit(jax_run):
    """The port's T = 3 session checkpoint (format ``ring/S4/T3``): the JAX
    session restored from it holds the port's state, step and data cursor."""
    ref = jax_run["jax"]
    assert jax_run["port_format"] == str(ref["port/format"]) == "ring/S4/T3"
    got = _ref_state(ref, "port")
    assert got.keys() == jax_run["port"].keys()
    for k, v in jax_run["port"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(ref["port/step"]) == S
    assert json.loads(str(ref["port/data"])) == json.loads(json.dumps(jax_run["port_data"]))


def test_port_restores_a_jax_tenant_checkpoint_bit_for_bit(jax_run):
    """The JAX T = 3 cached session saved after its 4 rounds: the port's
    restored session holds its state bit for bit and draws its next batch."""
    ref = jax_run["jax"]
    back = RingSession.restore(jax_run["jax_ck"], _configs()[1], _tc(lr=0.0),
                               policy=IntervalPolicy(initial_depth=DEPTH,
                                                     interval=JAX_INTERVAL),
                               params=_params(), device="cpu", log=lambda *a: None)
    assert back.n_tenants == JAX_T and back.backend.name == "cached"
    assert back.backend.format == str(ref["jax/format"]) == "ring/S4/T3"
    assert back.step_count == JAX_ROUNDS * S
    st = back.backend.state()
    got = _np_flat({"params": st["params"], "opt": st["opt"]})
    want = _ref_state(ref, f"r{JAX_ROUNDS - 1}")
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(back.data.next()[1], ref["next/tokens"])


# ---------------------------------------------------------------- refusals and (h) the CLI


def test_tenants_refused_where_the_reference_refuses_them():
    with pytest.raises(ValueError, match="reference oracle is single-tenant"):
        _session("reference", tenants=2)
    with pytest.raises(ValueError, match="ring concept"):
        _session("pjit", tenants=2)
    with pytest.raises(ValueError, match="tenants must be >= 1"):
        _session("fused", tenants=0)
    with pytest.raises(ValueError, match="needs the fused executor"):
        train.train_ring(_configs()[1], _tc(), rounds=1, n_stages=S, trainer="reference",
                         tenants=2, device="cpu")
    with pytest.raises(ValueError, match="tenant 2 outside"):
        _session("fused", tenants=2).export_adapters(tenant=2)


def test_cli_trains_tenants_exports_them_and_serves_them(capsys, tmp_path):
    """``--tenants 2 --adapter-store DIR`` trains two adapter sets and writes
    tenant0 and tenant1; the serve CLI on the same trunk serves the bare
    trunk and both tenants from DIR."""
    store = str(tmp_path / "adapters")
    common = ["--reduced", "--layers", "4", "--device", "cpu"]
    train.main(["--mode", "ring", "--arch", "qwen2.5-3b", "--stages", "2", "--rounds", "2",
                "--microbatches", "2",
                "--batch-size", "1", "--seq-len", "16", "--unfreeze-interval", "2",
                "--tenants", "2", "--adapter-store", store] + common)
    out = capsys.readouterr().out
    assert "exported 2 adapter bundle(s)" in out
    last = json.loads(out.splitlines()[-1])
    assert len(last["tenant_losses"]) == 2 and last["round"] == 1
    assert AdapterStore(store).names() == ["tenant0", "tenant1"]
    serve.main(["--adapter-store", store, "--requests", "3", "--max-new", "3",
                "--prompt-len", "8"] + common)
    out = capsys.readouterr().out
    assert "serving trunk + 2 tenants ['tenant0', 'tenant1']" in out
    assert "served 3 requests" in out
