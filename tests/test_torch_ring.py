"""The port's RingAda ring round and its oracle RingTrainer against the JAX
package, on the CPU.

Reduced stablelm-3b in f32 with 8 layers, a ring of S = 4 stages of 2
layers, M = 2 microbatches of 1 x 16 tokens per client. JAX materialises the
parameters; in numpy the adapters are then perturbed from a seed, so that
W_up != 0, as in tests/test_torch_train.py, and wq, wk and wv are scaled to
the fan-in init 1/sqrt(d_model). Both packages get the same arrays. On the
CPU the port runs the plain versions of its kernels.

Why wq, wk, wv: the reference's init takes their fan-in from the shape's
second-to-last axis, the head count, so q and k come out sqrt(d_model /
heads) = 8 times the fan-in scale and every softmax is nearly hard. Through
8 layers f32 rounding alone then moves the lowest adapter's gradient by 2.4%
in both packages (against the same computation in f64: JAX 0.024, the port
0.025), and 2-layer tests (tests/test_torch_train.py) do not see it. At the
fan-in scale both stay within 3e-6 of f64 and the tolerances below hold by
two orders of magnitude.

Tolerances, those of tests/test_torch_train.py: the loss 1e-5 relative;
gradients 5e-4 of the leaf's largest entry. The trainers are compared round
for round, each round from the reference's state after the last: each
owner iteration's loss; the adapters and the head after the round, 5e-4 of
the leaf's largest entry, and where an entry's gradient lay within 5e-4 of
the leaf's largest at a step, also twice the most that step can move it
(the file's 2 lr rule: the bias-corrected step moves an entry by about lr,
the raw step of the ring by up to (1 - b1) / sqrt(1 - b2) = 3.16 lr at the
first step and a little more later); the moments 5e-4 (m) and 1e-3 (v,
squares) of their largest entry. Batches, frozen rows, tick counts and the
helpers' outputs are held bit for bit.

The reference ring runs on four host devices, so its RingTrainer runs once
for the file in a subprocess (as tests/test_pipeline_ring.py does), with
XLA's optimisations off to halve its compile time: three rounds over
boundaries 6, 4 (a raw boundary of 5 that ``align_boundary`` rounds down)
and 0, at the default lr of 1e-3.
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

from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import partition as jax_partition  # noqa: E402
from repro.core import pipeline as jax_pl  # noqa: E402
from repro.core import training as jax_training  # noqa: E402
from repro.api.data import RingDataSource as JaxRingDataSource  # noqa: E402
from repro.data import pipeline as jax_data  # noqa: E402
from repro.models import losses as jax_losses  # noqa: E402
from repro.models import params as jax_prm  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import partition, training  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core import ring  # noqa: E402
from repro_torch.core.ring import RingTrainer  # noqa: E402
from repro_torch.core.unfreeze import UnfreezeSchedule  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL_FWD = 1e-5      # the loss, relative
RTOL_GRAD = 5e-4     # gradients and updates, of the leaf's largest entry
S, M, MB, SEQ, LAYERS = 4, 2, 1, 16, 8
LR = TrainConfig().learning_rate
DEPTHS = (2, 3, 8)   # boundaries 6, 5 -> 4, 0 at one round each


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tests run many small ops, which
    a thread per core slows a hundredfold when the suite's workers share the
    cores (1.06 s against 58 s for one test beside seven busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    return (jax_get_config("stablelm-3b").reduced(n_layers=LAYERS, repeats=LAYERS,
                                                  dtype="float32"),
            get_config("stablelm-3b").reduced(n_layers=LAYERS, repeats=LAYERS, dtype="float32"))


@functools.lru_cache(maxsize=None)
def _jax_params():
    """JAX's parameters (numpy leaves, read only) with the adapters perturbed
    from a numpy seed (W_up != 0) and wq, wk, wv at the fan-in scale."""
    cfg = _configs()[0]
    p = jax.tree.map(np.asarray, jax_prm.materialize(jax_prm.param_defs(cfg),
                                                     jax.random.key(0), cfg.dtype))
    rng = np.random.default_rng(1)
    (e,) = p["blocks"]
    ad = {k: (v.astype(np.float32) + 0.05 * rng.standard_normal(v.shape)).astype(v.dtype)
          for k, v in e["adapter"].items()}
    fan_in = np.sqrt(cfg.n_heads / cfg.d_model)          # from 1/sqrt(heads) to 1/sqrt(D)
    attn = {k: (v * fan_in).astype(v.dtype) if k in ("wq", "wk", "wv") else v
            for k, v in e["attn"].items()}
    return {**p, "blocks": ({**e, "adapter": ad, "attn": attn},)}


def _port_params():
    return bridge.params_from_jax(_jax_params(), _configs()[1], device="cpu")


def _data(seed=3):
    rng = np.random.default_rng(seed)
    shape = (S, M, MB, SEQ)
    return (rng.integers(0, 512, shape).astype(np.int32),
            rng.integers(0, 512, shape).astype(np.int32))


def _as_long(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).long() for a in arrays]


def _close(got, want, rtol, what="", slack=None, scale=None):
    """max |got - want| <= rtol x max |want| (or ``scale``), plus ``slack``."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if scale is None else scale, 1e-30)
    excess = np.abs(got - want) - rtol * scale - (0.0 if slack is None else slack)
    assert float(excess.max()) <= 0, f"{what}: {float(np.abs(got - want).max())} > {rtol} x " \
        f"{scale} (+ slack) by {float(excess.max())}"


def _flat(stage_tree):
    return [layer for stage in stage_tree for layer in stage]


# ---------------------------------------------------------------- geometry and helpers

LAYOUTS = [(8, 4, None), (8, 2, None), (32, 4, None), (7, 3, None), (14, 4, [4, 5, 2, 3])]


@pytest.mark.parametrize("n_blocks,n_stages,sizes", LAYOUTS)
def test_partition_helpers_equal_jax(n_blocks, n_stages, sizes):
    want = jax_partition.uniform_assignment(n_blocks, n_stages)
    assert partition.uniform_assignment(n_blocks, n_stages) == want
    spans = want if sizes is None else sizes
    norm = partition.normalize_spans(spans, n_blocks)
    assert norm == jax_partition.normalize_spans(spans, n_blocks)
    assert partition.span_sizes(norm) == jax_partition.span_sizes(norm)
    assert partition.span_boundaries(norm) == jax_partition.span_boundaries(norm)
    for b in range(n_blocks + 1):
        aligned = partition.align_boundary(norm, b)
        assert aligned == jax_partition.align_boundary(norm, b) <= b
        assert partition.frozen_stage_count(norm, aligned) == \
            jax_partition.frozen_stage_count(norm, aligned)
        if aligned != b:
            with pytest.raises(ValueError, match="not span-aligned"):
                partition.frozen_stage_count(norm, b)
    for got, ref in zip(pl.span_maps(norm), jax_pl.span_maps(norm)):
        np.testing.assert_array_equal(got, ref)
    assert pl.is_ragged(norm) == jax_pl.is_ragged(norm)
    for bad in ([(0, 3), (4, n_blocks)], [(0, 0), (0, n_blocks)]):
        with pytest.raises(ValueError, match="contiguous cover"):
            partition.normalize_spans(bad)


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_tick_counts_equal_jax(n_stages):
    for n_micro in (1, 2, 3, 8):
        for lps in (1, 2, 3):
            for boundary in range(0, n_stages * lps + 1, lps):
                want = jax_pl.pipeline_tick_counts(n_stages, n_micro, boundary, lps)
                assert pl.pipeline_tick_counts(n_stages, n_micro, boundary, lps) == want
                spans = jax_partition.uniform_assignment(n_stages * lps, n_stages)
                assert pl.pipeline_tick_counts(n_stages, n_micro, boundary, spans=spans) == \
                    jax_pl.pipeline_tick_counts(n_stages, n_micro, boundary, spans=spans)


def test_ring_batcher_equals_jax():
    jcfg, tcfg = _configs()
    for seed in (0, 5):
        want = JaxRingDataSource(jcfg, JaxTrainConfig(batch_size=MB, seq_len=SEQ,
                                                      n_microbatches=M, seed=seed), S)
        got = train.ring_data_source(tcfg, TrainConfig(batch_size=MB, seq_len=SEQ,
                                                       n_microbatches=M, seed=seed), S)
        for _ in range(3):
            _, wt, wl = want.next()
            gt, gl = got.next()
            assert gt.shape == (S, M, MB, SEQ) and gt.dtype == np.int32
            np.testing.assert_array_equal(gt, np.asarray(wt))
            np.testing.assert_array_equal(gl, np.asarray(wl))
    clients = jax_data.make_client_datasets(3, vocab=97, n_per_client=9, seq=12, seed=2)
    mine = pipeline.make_client_datasets(3, vocab=97, n_per_client=9, seq=12, seed=2)
    jb, tb = jax_data.RingBatcher(clients, 3, 2, seed=7), pipeline.RingBatcher(mine, 3, 2, seed=7)
    for _ in range(2):
        for a, b in zip(tb.next(), jb.next()):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_stage_stack_round_trips_and_holds_views():
    jcfg, tcfg = _configs()
    tp = _port_params()
    blocks, shared = pl.stage_stack(tp, tcfg, S)
    assert [len(stage) for stage in blocks] == [2] * S
    assert all(layer is tp["blocks"][2 * u + j] for u, stage in enumerate(blocks)
               for j, layer in enumerate(stage))
    assert "blocks" not in shared and shared["head"] is tp["head"]
    back = pl.unstack(blocks, tcfg, tp, shared)
    assert back["blocks"] == tp["blocks"] and back["embed"] is tp["embed"]
    # the stacked layout, against the reference's, on the same numpy arrays
    spans = pl.resolve_spans(LAYERS, S)
    entry = _jax_params()["blocks"][0]["adapter"]
    stacked = pl.stack_entry(entry, spans)
    want = jax_pl.stack_entry(entry, spans)
    for k in entry:
        assert stacked[k].shape == (S, 2, 1) + entry[k].shape[2:]
        np.testing.assert_array_equal(stacked[k], np.asarray(want[k]))
        np.testing.assert_array_equal(pl.unstack_entry(stacked, spans)[k], entry[k])


def test_bridge_carries_the_ring_state_exactly():
    _, tcfg = _configs()
    trainer = RingTrainer(tcfg, TrainConfig(), _port_params(), S, M)
    rng = np.random.default_rng(4)
    for stage in trainer.m_ad + trainer.v_ad:
        for a in stage:
            for t in a.values():
                t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    state = bridge.ring_state_to_jax(trainer)
    want = jax_pl.stack_entry(_jax_params()["blocks"][0]["adapter"], trainer.spans)
    for k in want:
        np.testing.assert_array_equal(state["adapter"][k], np.asarray(want[k]))
    other = RingTrainer(tcfg, TrainConfig(), _port_params(), S, M)
    bridge.ring_state_from_jax(state, other, device="cpu")
    again = bridge.ring_state_to_jax(other)
    for key, tree in state.items():
        for k, v in tree.items():
            np.testing.assert_array_equal(again[key][k], v)


# ---------------------------------------------------------------- the round


@pytest.mark.parametrize("owner", range(S))
def test_ring_loss_equals_single_device_loss_for_every_owner(owner):
    jcfg, tcfg = _configs()
    jp = _jax_params()
    tokens, labels = _data()
    toks = jnp.asarray(tokens[owner].reshape(M * MB, SEQ))
    labs = jnp.asarray(labels[owner].reshape(M * MB, SEQ))
    logits, _ = jax_tfm.forward(jp, toks, jcfg, impl="jnp")
    want, _ = jax_losses.cross_entropy(logits, labs)
    blocks, shared = pl.stage_stack(_port_params(), tcfg, S)
    for boundary in (0, 6):
        loss_fn = pl.make_ring_round(tcfg, n_stages=S, owner=owner, boundary=boundary,
                                     n_micro=M)
        got = loss_fn(blocks, shared, *_as_long(tokens, labels))
        _close(got, want, RTOL_FWD, f"owner {owner} boundary {boundary} loss")


@pytest.mark.parametrize("boundary", [4, 0])
def test_ring_gradients_equal_jax_grad(boundary):
    """Owner 1's ring gradients against jax.grad of the single-device loss on
    its data; the frozen stages' gradients are exact zeros."""
    jcfg, tcfg = _configs()
    jp = _jax_params()
    tokens, labels = _data()
    owner = 1
    toks = jnp.asarray(tokens[owner].reshape(M * MB, SEQ))
    labs = jnp.asarray(labels[owner].reshape(M * MB, SEQ))

    def loss_fn(tr):
        logits, _ = jax_tfm.forward(jp, toks, jcfg, boundary=boundary, impl="jnp",
                                    hot_adapters=tr["adapters"], head_params=tr["head"])
        return jax_losses.cross_entropy(logits, labs)[0]

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(
        jax_training.split_trainable(jp, boundary))
    blocks, shared = pl.stage_stack(_port_params(), tcfg, S)
    fn = pl.make_ring_train_round(tcfg, n_stages=S, owner=owner, boundary=boundary, n_micro=M)
    loss, (g_ad, g_hd) = fn(blocks, shared, *_as_long(tokens, labels))
    _close(loss, want_loss, RTOL_FWD, "loss")
    _close(g_hd["w"], want["head"]["w"], RTOL_GRAD, "head")
    assert [len(stage) for stage in g_ad] == [2] * S
    for i, g in enumerate(_flat(g_ad)):
        for k, t in g.items():
            if i < boundary:
                assert t.shape == blocks[0][0]["adapter"][k].shape
                assert not t.any(), f"frozen layer {i} {k}"
            else:
                _close(t, want["adapters"][0][k][i - boundary, 0], RTOL_GRAD, f"layer {i} {k}")


@pytest.mark.parametrize("boundary", [6, 2, 0])
def test_ring_equals_the_mean_of_per_microbatch_steps(boundary):
    """The identity the card checks: the ring's loss and gradients against the
    mean, over the owner's microbatches, of the single-device step's."""
    _, tcfg = _configs()
    tp = _port_params()
    tokens, labels = _as_long(*_data())
    owner = 2
    blocks, shared = pl.stage_stack(tp, tcfg, S)
    fn = pl.make_ring_train_round(tcfg, n_stages=S, owner=owner, boundary=boundary, n_micro=M)
    loss, (g_ad, g_hd) = fn(blocks, shared, tokens, labels)
    per = [training.loss_and_grads(tp, {"tokens": tokens[owner, m], "labels": labels[owner, m]},
                                   tcfg, boundary) for m in range(M)]
    _close(loss, sum(p[0] for p in per) / M, RTOL_FWD, "loss")
    _close(g_hd["w"], sum(p[2]["head"]["w"] for p in per) / M, RTOL_GRAD, "head")
    hot = _flat(g_ad)[boundary:]
    for i, g in enumerate(hot):
        for k, t in g.items():
            _close(t, sum(p[2]["adapters"][i][k] for p in per) / M, RTOL_GRAD,
                   f"layer {boundary + i} {k}")


def test_a_round_records_the_tick_ledger_and_keeps_frozen_stages():
    _, tcfg = _configs()
    sched = UnfreezeSchedule(depths=DEPTHS, interval=S)
    trainer = RingTrainer(tcfg, TrainConfig(n_microbatches=M, batch_size=MB, seq_len=SEQ),
                          _port_params(), S, M, schedule=sched)
    assert [trainer.boundary_at(r * S) for r in range(3)] == [6, 4, 0]
    for r in range(2):
        F = 3 - r
        before = [[{k: t.clone() for k, t in a.items()} for a in stage]
                  for stage in trainer.stage_adapters()[:F]]
        moments = [[{k: t.clone() for k, t in a.items()} for a in stage]
                   for stage in trainer.m_ad[:F]]
        top = {k: t.clone() for k, t in trainer.stage_adapters()[-1][-1].items()}
        rec = trainer.round(*_data(seed=r))
        assert rec["boundary"] == 2 * F and rec["step"] == S * (r + 1)
        want = pl.pipeline_tick_counts(S, M, 2 * F, 2)
        for it in rec["iterations"]:
            assert (it["fwd_ticks"], it["bwd_ticks"]) == (want["fwd_ticks"], want["bwd_ticks"])
            assert not any(it["launches"].values())          # the CPU runs no kernel
        for u in range(F):
            for a, b, m0, m1 in zip(trainer.stage_adapters()[u], before[u], trainer.m_ad[u],
                                    moments[u]):
                assert all(torch.equal(a[k], b[k]) and torch.equal(m0[k], m1[k]) for k in a)
        assert not torch.equal(trainer.stage_adapters()[-1][-1]["w_up"], top["w_up"])
        assert np.isfinite(rec["loss"])
    params = trainer.export_params()
    assert [b["adapter"] for b in params["blocks"]] == _flat(trainer.stage_adapters())
    assert params["head"] is trainer.shared["head"]


def test_ring_trainer_passes_impl_to_every_block(monkeypatch):
    """``impl="plain"`` reaches each block of both phases; on the CPU, where
    the kernel path runs the plain versions too, the round is the same bits."""
    _, tcfg = _configs()
    seen = []
    apply_block = pl.apply_block

    def spy(kind, cfg, layer, h, ctx):
        seen.append(ctx.impl)
        return apply_block(kind, cfg, layer, h, ctx)

    monkeypatch.setattr(pl, "apply_block", spy)
    tc = TrainConfig(n_microbatches=M, batch_size=MB, seq_len=SEQ)
    sched = UnfreezeSchedule(depths=(4,), interval=S)
    recs = {impl: RingTrainer(tcfg, tc, _port_params(), S, M, schedule=sched,
                              impl=impl).round(*_data())
            for impl in ("plain", "kernel")}
    assert seen == ["plain"] * (S * M * LAYERS) + ["kernel"] * (S * M * LAYERS)
    assert [it["loss"] for it in recs["plain"]["iterations"]] == \
        [it["loss"] for it in recs["kernel"]["iterations"]]


# ---------------------------------------------------------------- against the JAX RingTrainer

_JAX_RING = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_disable_most_optimizations", True)
from repro import compat
from repro.configs import TrainConfig, get_config
from repro.core.ring import RingTrainer
from repro.core.unfreeze import UnfreezeSchedule
from repro.models import params as P
from repro.api.data import RingDataSource

src, out = sys.argv[1], sys.argv[2]
S, M, MB, SEQ, LAYERS, LR, DEPTHS = {consts}
cfg = get_config("stablelm-3b").reduced(n_layers=LAYERS, repeats=LAYERS, dtype="float32")
structure = jax.tree.structure(P.param_defs(cfg), is_leaf=lambda x: isinstance(x, P.PD))
arrays = np.load(src)
params = jax.tree.unflatten(structure,
                            [jnp.asarray(arrays[f"leaf{{i}}"]) for i in range(len(arrays.files))])
tc = TrainConfig(learning_rate=LR, n_microbatches=M, batch_size=MB, seq_len=SEQ)
mesh = compat.make_mesh((S,), ("stage",))
trainer = RingTrainer(cfg, tc, mesh, params, S, M,
                      schedule=UnfreezeSchedule(depths=DEPTHS, interval=S))
losses = []
step = trainer._iteration
trainer._iteration = lambda *a: (losses.append(step(*a)), losses[-1])[1]
data = RingDataSource(cfg, tc, S)
res = {{}}

def save(tag):
    for name, tree in (("adapter", trainer.stage_blocks["adapter"]), ("m_ad", trainer.m_ad),
                       ("v_ad", trainer.v_ad), ("head", trainer.shared["head"]),
                       ("m_hd", trainer.m_hd), ("v_hd", trainer.v_hd)):
        for k, v in tree.items():
            res[f"{{tag}}/{{name}}/{{k}}"] = np.asarray(v)

save("start")
with compat.set_mesh(mesh):
    for r in range(3):
        _, tokens, labels = data.next()
        rec = trainer.round(tokens, labels)
        res[f"r{{r}}/tokens"], res[f"r{{r}}/labels"] = np.asarray(tokens), np.asarray(labels)
        res[f"r{{r}}/boundary"] = np.asarray(rec["boundary"])
        res[f"r{{r}}/loss"] = np.asarray(rec["loss"])
        save(f"r{{r}}")
res["losses"] = np.asarray(losses)
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def jax_ring_run(tmp_path_factory):
    """The JAX RingTrainer's three rounds, run once in a 4-host-device subprocess."""
    tmp = tmp_path_factory.mktemp("jax_ring")
    src, out = tmp / "params.npz", tmp / "ring.npz"
    np.savez(src, **{f"leaf{i}": x for i, x in enumerate(jax.tree.leaves(_jax_params()))})
    code = _JAX_RING.format(consts=repr((S, M, MB, SEQ, LAYERS, LR, DEPTHS)))
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={S}",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", code, str(src), str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(out))


def _raw_adam_reach(tc, t):
    """The most the raw Adam step t (from 1) can move an entry, over lr:
    |m_t| / sqrt(v_t) <= (1 - b1) / sqrt(1 - b2) * sqrt(sum_{k<t} (b1^2 / b2)^k)."""
    q = tc.beta1 ** 2 / tc.beta2
    return (1 - tc.beta1) / np.sqrt(1 - tc.beta2) * np.sqrt(sum(q ** k for k in range(t)))


def test_ring_trainer_matches_jax_ring_trainer_round_for_round(jax_ring_run):
    """Each round from the reference's state after the last: the same batches,
    the boundary walk 6, 4, 0, the owner iterations' losses, the adapters and
    the head after the round, and the moments."""
    ref = jax_ring_run
    _, tcfg = _configs()
    tc = TrainConfig(learning_rate=LR, n_microbatches=M, batch_size=MB, seq_len=SEQ)
    trainer = RingTrainer(tcfg, tc, _port_params(), S, M,
                          schedule=UnfreezeSchedule(depths=DEPTHS, interval=S))
    data = train.ring_data_source(tcfg, tc, S)
    state = lambda tag: {name: {k[len(f"{tag}/{name}/"):]: v for k, v in ref.items()
                                if k.startswith(f"{tag}/{name}/")}
                         for name in ("adapter", "m_ad", "v_ad", "head", "m_hd", "v_hd")}
    mine = bridge.ring_state_to_jax(trainer)
    for name, tree in state("start").items():
        for k, v in tree.items():
            np.testing.assert_array_equal(mine[name][k], v)
    for r in range(3):
        start = state("start" if r == 0 else f"r{r - 1}")
        bridge.ring_state_from_jax(start, trainer, device="cpu")
        tokens, labels = data.next()
        np.testing.assert_array_equal(tokens, ref[f"r{r}/tokens"])
        np.testing.assert_array_equal(labels, ref[f"r{r}/labels"])
        F = (3, 2, 0)[r]                    # frozen stages
        slack = {}

        def add_slack(key, g, t):
            g = g.float().numpy()
            near0 = np.abs(g) <= RTOL_GRAD * np.abs(g).max()
            reach = 2 * LR * _raw_adam_reach(tc, t)
            slack[key] = slack.get(key, 0.0) + np.where(near0, reach, 0.0)

        # each owner iteration's gradients give the slack of the entries near 0
        real = trainer.round_fn

        def spying(owner, boundary):
            fn = real(owner, boundary)

            def run(*a, **kw):
                loss, (g_ad, g_hd) = fn(*a, **kw)
                t = trainer.step + 1
                add_slack("head", g_hd["w"], t)
                for i, g in enumerate(_flat(g_ad)):
                    for k, v in g.items():
                        add_slack((i, k), v, t)
                return loss, (g_ad, g_hd)
            return run

        trainer.round_fn = spying
        rec = trainer.round(tokens, labels)
        trainer.round_fn = real
        want_b = int(ref[f"r{r}/boundary"])
        assert rec["boundary"] == want_b == (6, 4, 0)[r]
        assert [it["boundary"] for it in rec["iterations"]] == [want_b] * S
        for it, want in zip(rec["iterations"], ref["losses"][S * r:S * (r + 1)]):
            _close(it["loss"], want, RTOL_FWD, f"round {r} owner {it['owner']} loss")
        _close(rec["loss"], ref[f"r{r}/loss"], RTOL_FWD, f"round {r} loss")
        got, end = bridge.ring_state_to_jax(trainer), state(f"r{r}")
        _close(got["head"]["w"], end["head"]["w"], RTOL_GRAD, f"round {r} head", slack["head"])
        for k in ("w_down", "w_up"):
            # the frozen stages bit for bit: neither side moved them
            for name in ("adapter", "m_ad", "v_ad"):
                np.testing.assert_array_equal(got[name][k][:F], start[name][k][:F])
                np.testing.assert_array_equal(end[name][k][:F], start[name][k][:F])
            for u in range(F, S):
                assert (got["adapter"][k][u] != start["adapter"][k][u]).any(), \
                    f"round {r}: hot stage {u} did not move"
            layer_slack = np.stack([slack[(i, k)] for i in range(LAYERS)]).reshape(
                got["adapter"][k].shape)
            _close(got["adapter"][k], end["adapter"][k], RTOL_GRAD, f"round {r} adapters {k}",
                   layer_slack)
            _close(got["m_ad"][k], end["m_ad"][k], RTOL_GRAD, f"round {r} m {k}")
            _close(got["v_ad"][k], end["v_ad"][k], 2 * RTOL_GRAD, f"round {r} v {k}")
        _close(got["m_hd"]["w"], end["m_hd"]["w"], RTOL_GRAD, f"round {r} m head")
        _close(got["v_hd"]["w"], end["v_hd"]["w"], 2 * RTOL_GRAD, f"round {r} v head")


def test_ring_trainer_loss_is_the_f32_mean_of_its_owners(jax_ring_run):
    """A round's loss is the f32 mean of its owners' losses, the JAX
    package's: the port's ``mean_loss`` of the JAX RingTrainer's owner
    losses is its round loss bit for bit, and a port round's loss is
    ``mean_loss`` of its own owners' (the mean the JAX RingTrainer takes,
    ``jnp.mean`` in f32)."""
    ref = jax_ring_run
    for r in range(3):
        owners = [float(x) for x in ref["losses"][S * r:S * (r + 1)]]
        assert ring.mean_loss(owners) == float(ref[f"r{r}/loss"]) == \
            float(jnp.mean(jnp.array(owners)))
    _, tcfg = _configs()
    tc = TrainConfig(learning_rate=LR, n_microbatches=M, batch_size=MB, seq_len=SEQ)
    trainer = RingTrainer(tcfg, tc, _port_params(), S, M,
                          schedule=UnfreezeSchedule(depths=DEPTHS[:1], interval=S))
    rec = trainer.round(*train.ring_data_source(tcfg, tc, S).next())
    owners = [it["loss"] for it in rec["iterations"]]
    assert rec["loss"] == ring.mean_loss(owners) == float(jnp.mean(jnp.array(owners)))


# ---------------------------------------------------------------- refusals, CLI, imports


def test_cached_ticks_and_unaligned_boundaries_are_refused():
    """The activation cache's tick counts (once refused) against the JAX
    function, uniform and packed; an unaligned boundary is still refused."""
    _, tcfg = _configs()
    for boundary in (0, 2, 4, 6, 8):
        for packed in (False, True):
            got = pl.pipeline_tick_counts(4, 2, boundary, 2, cached=True, packed=packed)
            assert got == jax_pl.pipeline_tick_counts(4, 2, boundary, 2, cached=True,
                                                      packed=packed)
            assert got["phase_a_round_ticks"] == 0 and got["fwd_ticks"] == got["bwd_ticks"]
    with pytest.raises(ValueError, match="not span-aligned"):
        pl.make_ring_round(tcfg, n_stages=S, owner=0, boundary=5, n_micro=M)


def test_ring_cli_on_the_cpu(capsys):
    """One line per round, the boundary walking down, then the last round as JSON."""
    train.main(["--mode", "ring", "--trainer", "reference", "--arch", "stablelm-3b",
                "--reduced", "--layers", "4", "--stages", "2", "--rounds", "3",
                "--unfreeze-interval", "2", "--microbatches", "2", "--batch-size", "1",
                "--seq-len", "16", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    lines = [ln.split() for ln in out if ln.startswith("round")]
    assert [ln[:6] for ln in lines] == [["round", "0", "boundary", "2", "depth", "2"],
                                        ["round", "1", "boundary", "2", "depth", "2"],
                                        ["round", "2", "boundary", "0", "depth", "4"]]
    assert all(np.isfinite(float(ln[7])) for ln in lines)
    last = json.loads(out[-1])
    assert (last["round"], last["boundary"], last["step"]) == (2, 0, 6)


def test_ring_cli_trains_at_the_ring_lr_by_default(monkeypatch):
    """The ring's lr is RING_LR unless --lr is given; the one-device mode's 1e-3.
    The unfreeze interval is the reference's 40 in both modes."""
    got = {}
    monkeypatch.setattr(train, "train_ring", lambda cfg, tc, **kw: got.setdefault("ring", tc)
                        and {"history": [{}]})
    monkeypatch.setattr(train, "train", lambda cfg, tc, **kw: got.setdefault("pjit", tc))
    ring = ["--mode", "ring", "--trainer", "reference", "--reduced", "--device", "cpu"]
    train.main(ring)
    train.main(["--reduced", "--device", "cpu"])
    assert (got["ring"].learning_rate, got["pjit"].learning_rate) == (train.RING_LR, 1e-3)
    assert got["ring"].unfreeze_interval == got["pjit"].unfreeze_interval == 40
    got.clear()
    train.main(ring + ["--lr", "3e-4"])
    assert got["ring"].learning_rate == 3e-4


def test_port_imports_neither_jax_nor_repro():
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
       and sys.modules[m] is not None]
assert not bad, bad
assert {"repro_torch.core.ring", "repro_torch.core.pipeline",
        "repro_torch.core.executor"} <= set(names)
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert int(run.stdout.split()[-1]) > 30
