"""The port's heterogeneous ring and fused RingExecutor against the JAX
package, on the CPU.

Reduced stablelm-3b in f32 with 8 layers, a ring of S = 4 stages, M = 2
microbatches of 1 x 16 tokens per client, on the balanced layout (2 layers a
stage) and on the ragged [3, 2, 2, 1]. The port materialises the parameters
from a seed and the bridge carries them to JAX's layout; in numpy the
adapters are then perturbed (W_up != 0) and wq, wk, wv scaled to the fan-in
init, as in tests/test_torch_ring.py (which says why). Both packages get the
same arrays. On the CPU the port runs the plain versions of its kernels, and
``RingExecutor`` runs its round eagerly.

Tolerances, tests/test_torch_ring.py's: the loss 1e-5 relative; gradients
and updates 5e-4 of the leaf's largest entry, plus, where an entry's
gradient lay within 5e-4 of the leaf's largest at a step, twice the most the
raw Adam step can move it (the 2 lr rule); the moments 5e-4 (m) and 1e-3
(v) of their largest entry. Batches, frozen rows, tick ledgers and the
partitioner's layouts are held bit for bit.

The port's ``RingTrainer`` is held to the JAX one owner iteration by owner
iteration, each from the JAX state before it. A round compounds: the raw
step moves an entry whose gradient lies at f32's rounding by 3.16 lr in
either direction (the 2 lr rule's entries), and within the round that change
reaches the later iterations' gradients and moments beyond 5e-4 (it did on
the ragged walk below, where each iteration alone agrees within 4e-6 in the
moments). The executor runs a round as one program, so it is held round by
round where that does not compound (the boundaries, the S losses, the tick
ledger, the frozen stages) and to the port's ``RingTrainer`` over the same
round from the same state, bit for bit.

One 4-host-device JAX subprocess for the file (XLA's optimisations off, as in
tests/test_torch_ring.py) runs the JAX ``RingExecutor`` for three rounds on
the balanced layout, boundaries 6, 4, 2 (F = 3 and 2 on the packed conveyor,
F = 1 on the per-owner scan), and the JAX ``RingTrainer`` for two rounds on
[3, 2, 2, 1], boundaries 5 and 3 (a raw 4 that ``align_boundary`` rounds down
across a span edge).

The JAX executor's head gradient is S times its ``RingTrainer``'s under the
JAX this repository runs: its owner iteration sums the head's cotangent over
the stages (``lax.psum``), which ``shard_map`` has already summed. Its head
moments come out S and S^2 times the oracle's (held below). Adam's step is
blind to that scale except through eps, which moves the entries whose
gradient is near eps by up to about lr at the first step, and the change
reaches every later loss and update of the round. So the JAX executor walks
at lr 0, where no parameter moves and its head gradient reaches only the head
moments: it is held for the boundaries, all S losses of each round, the
adapters' moments, the tick ledger, the builds and the step count. The
updates are held to the oracle: the port's executor to the JAX
``RingTrainer`` on the ragged walk, and to the port's ``RingTrainer`` bit for
bit, which tests/test_torch_ring.py holds to the JAX one. (Holding the
balanced walk's losses at lr 1e-3 against the JAX ``RingTrainer`` round by
round was tried: the round compounds past 1e-5 at owner 2, 1.18e-5.)
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

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import partition as jax_partition  # noqa: E402
from repro.core import pipeline as jax_pl  # noqa: E402
from repro.core import simulator as jax_sim  # noqa: E402
from repro.core import training as jax_training  # noqa: E402
from repro.models import losses as jax_losses  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import partition  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core.executor import RingExecutor  # noqa: E402
from repro_torch.core.ring import RingTrainer  # noqa: E402
from repro_torch.core.unfreeze import UnfreezeSchedule  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL_FWD = 1e-5      # the loss, relative
RTOL_GRAD = 5e-4     # gradients and updates, of the leaf's largest entry
S, M, MB, SEQ, LAYERS = 4, 2, 1, 16, 8
LR = TrainConfig().learning_rate
EX_LR = 0.0                         # the JAX executor's walk (the module docstring says why)
UNIFORM_DEPTHS = (2, 4, 6)          # boundaries 6, 4, 2: F = 3, 2, 1
RAGGED = (3, 2, 2, 1)
RAGGED_DEPTHS = (3, 4)              # boundaries 5, 4 -> 3: F = 2, 1
SPEEDS = (1.0, 1.25, 0.5, 0.75)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tests run many small ops, which
    a thread per core slows a hundredfold when the suite's workers share the
    cores (1.06 s against 58 s for one test beside seven busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(layers=LAYERS):
    return (jax_get_config("stablelm-3b").reduced(n_layers=layers, repeats=layers,
                                                  dtype="float32"),
            get_config("stablelm-3b").reduced(n_layers=layers, repeats=layers, dtype="float32"))


@functools.lru_cache(maxsize=None)
def _jax_params(layers=LAYERS):
    """The parameters in JAX's layout (numpy leaves, read only) with the
    adapters perturbed from a numpy seed and wq, wk, wv at the fan-in scale."""
    cfg, tcfg = _configs(layers)
    p = bridge.params_to_jax(prm.materialize(tcfg, seed=0, device="cpu"), tcfg)
    rng = np.random.default_rng(1)
    (e,) = p["blocks"]
    ad = {k: (v.astype(np.float32) + 0.05 * rng.standard_normal(v.shape)).astype(v.dtype)
          for k, v in e["adapter"].items()}
    fan_in = np.sqrt(cfg.n_heads / cfg.d_model)
    attn = {k: (v * fan_in).astype(v.dtype) if k in ("wq", "wk", "wv") else v
            for k, v in e["attn"].items()}
    return {**p, "blocks": ({**e, "adapter": ad, "attn": attn},)}


def _port_params(layers=LAYERS):
    return bridge.params_from_jax(_jax_params(layers), _configs(layers)[1], device="cpu")


def _data(seed, shape=(S, M, MB, SEQ)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 512, shape).astype(np.int32),
            rng.integers(0, 512, shape).astype(np.int32))


def _as_long(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).long() for a in arrays]


def _tc(lr=LR, **kw):
    return TrainConfig(learning_rate=lr, n_microbatches=M, batch_size=MB, seq_len=SEQ, **kw)


def _close(got, want, rtol, what="", slack=None):
    """max |got - want| <= rtol x max |want|, plus ``slack``."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    excess = np.abs(got - want) - rtol * scale - (0.0 if slack is None else slack)
    assert float(excess.max()) <= 0, f"{what}: {float(np.abs(got - want).max())} > {rtol} x " \
        f"{scale} (+ slack) by {float(excess.max())}"


def _flat(stage_tree):
    return [layer for stage in stage_tree for layer in stage]


def _raw_adam_reach(tc, t):
    """The most the raw Adam step t (from 1) can move an entry, over lr."""
    q = tc.beta1 ** 2 / tc.beta2
    return (1 - tc.beta1) / np.sqrt(1 - tc.beta2) * np.sqrt(sum(q ** k for k in range(t)))


class _Slack:
    """The 2 lr rule's slack of each entry, from the gradients each update saw."""

    def __init__(self, tc):
        self.tc, self.by_key = tc, {}

    def add(self, key, g, t):
        g = g.detach().float().numpy()
        near0 = np.abs(g) <= RTOL_GRAD * np.abs(g).max()
        reach = 2 * LR * _raw_adam_reach(self.tc, t)
        self.by_key[key] = self.by_key.get(key, 0.0) + np.where(near0, reach, 0.0)

    def layers(self, k, n_layers=LAYERS):
        """Layer entries ``(i, k)`` stacked [R, 1, ...] (zero where no update)."""
        return np.stack([np.broadcast_to(self.by_key.get((i, k), 0.0), self.shape[k])
                         for i in range(n_layers)])[:, None]


def _spy_trainer(trainer, slack):
    """Record each owner iteration's gradients of ``trainer`` in ``slack``."""
    real = trainer.round_fn
    slack.shape = {k: t.shape for k, t in trainer.stage_adapters()[0][0].items()}

    def spying(owner, boundary):
        fn = real(owner, boundary)

        def run(*a, **kw):
            loss, (g_ad, g_hd) = fn(*a, **kw)
            t = trainer.step + 1
            slack.add("head", g_hd["w"], t)
            for i, g in enumerate(_flat(g_ad)):
                for k, v in g.items():
                    slack.add((i, k), v, t)
            return loss, (g_ad, g_hd)
        return run

    trainer.round_fn = spying


def _valid(stacked, spans):
    """The real rows of a padded [S, max_span, ...] stack, as [R, ...]."""
    return pl.unstack_entry({"x": np.asarray(stacked)}, pl.resolve_spans(LAYERS, S, spans))["x"]


# ---------------------------------------------------------------- the partitioner

PROFILE_GRID = [(8, (1.0, 1.0, 1.0, 1.0)), (8, (1.0, 2.0, 1.0, 0.5)), (14, SPEEDS),
                (32, SPEEDS), (13, (3.0, 1.0, 1.0)), (9, (0.25, 4.0)), (7, (1.0,) * 7)]


@pytest.mark.parametrize("n_blocks,speeds", PROFILE_GRID)
def test_partitioner_equals_jax(n_blocks, speeds):
    mine = partition.parse_device_profiles(speeds)
    want = jax_partition.parse_device_profiles(speeds)
    assert [(p.compute_speed, p.memory_mb, p.link_mbps) for p in mine] == \
        [(p.compute_speed, p.memory_mb, p.link_mbps) for p in want]
    assert partition.spans_from_profiles(n_blocks, mine) == \
        jax_partition.spans_from_profiles(n_blocks, want)
    costs = list(np.random.default_rng(n_blocks).uniform(0.5, 2.0, n_blocks))
    assert partition.assign_layers(costs, [0.0] * n_blocks, mine) == \
        jax_partition.assign_layers(costs, [0.0] * n_blocks, want)


def test_partitioner_gives_the_papers_layouts_and_refuses_bad_speeds():
    profiles = partition.parse_device_profiles(SPEEDS)
    assert partition.spans_from_profiles(14, profiles) == ((0, 4), (4, 9), (9, 11), (11, 14))
    assert partition.spans_from_profiles(32, profiles) == ((0, 9), (9, 21), (21, 25), (25, 32))
    for bad in ([1.0, 0.0], [-1.0], [float("nan")], []):
        for parse in (partition.parse_device_profiles, jax_partition.parse_device_profiles):
            with pytest.raises(ValueError):
                parse(bad)
    with pytest.raises(ValueError, match="link_mbps"):
        partition.DeviceProfile(1.0, 1.0, link_mbps=0.0)


# ---------------------------------------------------------------- geometry and ticks

TICK_LAYOUTS = [(1, 1, 1, 1), (2, 2, 2, 2), RAGGED, (4, 5, 2, 3), (3, 5)]


@pytest.mark.parametrize("sizes", TICK_LAYOUTS)
def test_tick_counts_equal_jax_and_the_simulator(sizes):
    """Packed and unpacked, uniform and ragged: the port's closed forms, the
    JAX package's, and the simulator's Phase-A round ticks (for boundaries
    with a hot stage, where the simulator is defined)."""
    spans = partition.normalize_spans(sizes)
    n = len(spans)
    for n_micro in (1, 2, 4):
        for boundary in partition.span_boundaries(spans):
            for packed in (False, True):
                got = pl.pipeline_tick_counts(n, n_micro, boundary, spans=spans, packed=packed)
                assert got == jax_pl.pipeline_tick_counts(n, n_micro, boundary, spans=spans,
                                                          packed=packed)
                if boundary < spans[-1][1]:
                    sim = jax_sim.spmd_tick_round(spans, n_micro, boundary, packed=packed)
                    assert got["phase_a_round_ticks"] == sim["phase_a_round_ticks"]
    # ROADMAP.md's record: S = 4, M = 4, F = 3 is 18 packed ticks against 24
    packed = pl.pipeline_tick_counts(4, 4, 3, 1, packed=True)
    assert (packed["phase_a_round_ticks"], packed["phase_a_saved_ticks"]) == (18, 6)
    assert pl.pipeline_tick_counts(4, 4, 3, 1)["phase_a_round_ticks"] == 24


@pytest.mark.parametrize("sizes", [RAGGED, (1, 3, 2, 2)])
def test_ragged_stage_stack_equals_jax(sizes):
    spans = pl.resolve_spans(LAYERS, S, sizes)
    _, tcfg = _configs()
    tp = _port_params()
    blocks, _ = pl.stage_stack(tp, tcfg, S, spans=spans)
    assert [len(stage) for stage in blocks] == list(sizes)
    assert [layer for stage in blocks for layer in stage] == tp["blocks"]
    entry = _jax_params()["blocks"][0]["adapter"]
    want = jax_pl.stack_entry(entry, spans)
    for k in entry:
        stacked = pl.stack_entry(entry, spans)[k]
        assert stacked.shape == (S, max(sizes)) + entry[k].shape[1:]
        np.testing.assert_array_equal(stacked, np.asarray(want[k]))
        np.testing.assert_array_equal(pl.unstack_entry({k: stacked}, spans)[k], entry[k])
        as_tensor = pl.stack_entry({k: torch.from_numpy(entry[k])}, spans)[k]
        np.testing.assert_array_equal(as_tensor.numpy(), stacked)


@pytest.mark.parametrize("sizes", [(2, 2, 2, 2), RAGGED])
def test_packed_phase_a_equals_per_owner_phase_a(sizes):
    """Each owner's slice of the conveyor is ``ring_phase_a``'s bit for bit,
    and Phase A then Phase B is ``make_ring_round``'s loss."""
    _, tcfg = _configs()
    spans = pl.resolve_spans(LAYERS, S, sizes)
    blocks, shared = pl.stage_stack(_port_params(), tcfg, S, spans=spans)
    tokens, labels = _as_long(*_data(3))
    emb_g = pl.gather_embeddings(tcfg, shared, tokens)
    for boundary in partition.span_boundaries(spans)[:-1]:
        geo = dict(n_stages=S, boundary=boundary, n_micro=M, spans=spans)
        ticks = []
        packed = pl.ring_phase_a_packed(tcfg, record=ticks.append, **geo)(blocks, emb_g)
        F = partition.frozen_stage_count(spans, boundary)
        assert ticks == ([S * M + F - 1] if F else [])
        phase_a = pl.ring_phase_a(tcfg, **geo)
        phase_b = pl.ring_phase_b(tcfg, **geo)
        for owner in range(S):
            alone = phase_a(blocks, emb_g[owner])
            assert all(torch.equal(a, b) for a, b in zip(packed[owner], alone, strict=True))
            loss = phase_b(blocks, shared, packed[owner], labels[owner])
            want = pl.make_ring_round(tcfg, owner=owner, **geo)(blocks, shared, tokens, labels)
            assert torch.equal(loss, want), (boundary, owner)


@pytest.mark.parametrize("boundary", [3])
def test_ragged_ring_gradients_equal_jax_grad(boundary):
    """On [3, 2, 2, 1] at boundary 3 (hot stages of 2, 2 and 1 layers): owner
    1's ring loss and gradients against jax.grad of the single-device loss on
    its data; the frozen stage's gradients are exact zeros."""
    jcfg, tcfg = _configs()
    jp = _jax_params()
    tokens, labels = _data(3)
    owner = 1
    toks = jnp.asarray(tokens[owner].reshape(M * MB, SEQ))
    labs = jnp.asarray(labels[owner].reshape(M * MB, SEQ))

    def loss_fn(tr):
        logits, _ = jax_tfm.forward(jp, toks, jcfg, boundary=boundary, impl="jnp",
                                    hot_adapters=tr["adapters"], head_params=tr["head"])
        return jax_losses.cross_entropy(logits, labs)[0]

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(
        jax_training.split_trainable(jp, boundary))
    blocks, shared = pl.stage_stack(_port_params(), tcfg, S, spans=RAGGED)
    fn = pl.make_ring_train_round(tcfg, n_stages=S, owner=owner, boundary=boundary, n_micro=M,
                                  spans=RAGGED)
    loss, (g_ad, g_hd) = fn(blocks, shared, *_as_long(tokens, labels))
    _close(loss, want_loss, RTOL_FWD, "loss")
    _close(g_hd["w"], want["head"]["w"], RTOL_GRAD, "head")
    assert [len(stage) for stage in g_ad] == list(RAGGED)
    for i, g in enumerate(_flat(g_ad)):
        for k, t in g.items():
            if i < boundary:
                assert not t.any(), f"frozen layer {i} {k}"
            else:
                _close(t, want["adapters"][0][k][i - boundary, 0], RTOL_GRAD, f"layer {i} {k}")


# ---------------------------------------------------------------- against the JAX package

_JAX_RUN = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_disable_most_optimizations", True)
from repro import compat
from repro.configs import TrainConfig, get_config
from repro.core.executor import RingExecutor
from repro.core.ring import RingTrainer
from repro.core.unfreeze import UnfreezeSchedule
from repro.models import params as P

src, out = sys.argv[1], sys.argv[2]
S, M, MB, SEQ, LAYERS, LR, EX_LR, UNIFORM_DEPTHS, RAGGED, RAGGED_DEPTHS = {consts}
cfg = get_config("stablelm-3b").reduced(n_layers=LAYERS, repeats=LAYERS, dtype="float32")
structure = jax.tree.structure(P.param_defs(cfg), is_leaf=lambda x: isinstance(x, P.PD))
arrays = np.load(src)
params = jax.tree.unflatten(structure,
                            [jnp.asarray(arrays[f"leaf{{i}}"]) for i in range(len(arrays.files))])
tc = TrainConfig(learning_rate=LR, n_microbatches=M, batch_size=MB, seq_len=SEQ)
tc_ex = TrainConfig(learning_rate=EX_LR, n_microbatches=M, batch_size=MB, seq_len=SEQ)
mesh = compat.make_mesh((S,), ("stage",))
rng = np.random.default_rng(11)
res = {{}}

def save(tag, trees):
    for name, tree in trees.items():
        for k, v in tree.items():
            res[f"{{tag}}/{{name}}/{{k}}"] = np.asarray(v)

def save_ex(tag):
    o = ex.opt_state
    save(tag, {{"adapter": ex.stage_blocks["adapter"], "head": ex.shared["head"],
               "m_ad": o["m"]["adapter"], "v_ad": o["v"]["adapter"], "m_hd": o["m"]["head"],
               "v_hd": o["v"]["head"]}})
    res[f"{{tag}}/count"] = np.asarray(o["count"])

def save_tr(tag):
    save(tag, {{"adapter": tr.stage_blocks["adapter"], "m_ad": tr.m_ad, "v_ad": tr.v_ad,
               "head": tr.shared["head"], "m_hd": tr.m_hd, "v_hd": tr.v_hd}})

with compat.set_mesh(mesh):
    ex = RingExecutor(cfg, tc_ex, mesh, params, S, M, donate=False,
                      schedule=UnfreezeSchedule(depths=UNIFORM_DEPTHS, interval=S))
    save_ex("ex/start")
    for r in range(3):
        tokens = rng.integers(0, 512, (S, M, MB, SEQ)).astype(np.int32)
        labels = rng.integers(0, 512, (S, M, MB, SEQ)).astype(np.int32)
        m = RingExecutor.materialize_metrics(ex.round(jnp.asarray(tokens), jnp.asarray(labels)))
        res[f"ex/r{{r}}/tokens"], res[f"ex/r{{r}}/labels"] = tokens, labels
        res[f"ex/r{{r}}/boundary"] = np.asarray(m["boundary"])
        res[f"ex/r{{r}}/losses"] = np.asarray(m["losses"])
        res[f"ex/r{{r}}/ledger"] = np.asarray(json.dumps(ex.measured_tick_ledger(m["boundary"])))
        save_ex(f"ex/r{{r}}")
    res["ex/compile"] = np.asarray(json.dumps(ex.compile_counts()))

    tr = RingTrainer(cfg, tc, mesh, params, S, M, spans=list(RAGGED),
                     schedule=UnfreezeSchedule(depths=RAGGED_DEPTHS, interval=S))
    losses = []
    step = tr._iteration

    def iteration(*a):
        losses.append(step(*a))
        save_tr(f"tr/it{{len(losses)}}")
        return losses[-1]

    tr._iteration = iteration
    save_tr("tr/it0")
    for r in range(len(RAGGED_DEPTHS)):
        tokens = rng.integers(0, 512, (S, M, MB, SEQ)).astype(np.int32)
        labels = rng.integers(0, 512, (S, M, MB, SEQ)).astype(np.int32)
        rec = tr.round(jnp.asarray(tokens), jnp.asarray(labels))
        res[f"tr/r{{r}}/tokens"], res[f"tr/r{{r}}/labels"] = tokens, labels
        res[f"tr/r{{r}}/boundary"] = np.asarray(rec["boundary"])
    res["tr/losses"] = np.asarray(losses)
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX RingExecutor's and RingTrainer's rounds, run once in a
    4-host-device subprocess."""
    tmp = tmp_path_factory.mktemp("jax_executor")
    src, out = tmp / "params.npz", tmp / "run.npz"
    np.savez(src, **{f"leaf{i}": x for i, x in enumerate(jax.tree.leaves(_jax_params()))})
    code = _JAX_RUN.format(consts=repr((S, M, MB, SEQ, LAYERS, LR, EX_LR, UNIFORM_DEPTHS,
                                        RAGGED, RAGGED_DEPTHS)))
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={S}",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", code, str(src), str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(out))


def _state(ref, tag, names=("adapter", "m_ad", "v_ad", "head", "m_hd", "v_hd")):
    return {name: {k[len(f"{tag}/{name}/"):]: v for k, v in ref.items()
                   if k.startswith(f"{tag}/{name}/")} for name in names}


def _as_executor_state(st, count):
    return {"adapter": st["adapter"], "head": st["head"], "opt_state": {
        "m": {"adapter": st["m_ad"], "head": st["m_hd"]},
        "v": {"adapter": st["v_ad"], "head": st["v_hd"]}, "count": count}}


def _as_trainer_state(state):
    o = state["opt_state"]
    return {"adapter": state["adapter"], "head": state["head"], "m_ad": o["m"]["adapter"],
            "v_ad": o["v"]["adapter"], "m_hd": o["m"]["head"], "v_hd": o["v"]["head"]}


def _hold_round(got, start, end, F, slack, spans, what):
    """The state after a round against the reference's: frozen stages bit for
    bit on both sides, hot stages moved, the rest within the tolerances."""
    _close(got["head"]["w"], end["head"]["w"], RTOL_GRAD, f"{what} head",
           slack.by_key.get("head"))
    sizes = partition.span_sizes(pl.resolve_spans(LAYERS, S, spans))
    for k in ("w_down", "w_up"):
        for name in ("adapter", "m_ad", "v_ad"):
            for u in range(S):
                mine, theirs, was = (x[name][k][u, :sizes[u]] for x in (got, end, start))
                if u < F:
                    np.testing.assert_array_equal(mine, was)
                    np.testing.assert_array_equal(theirs, was)
                elif name == "adapter":
                    assert (mine != was).any(), f"{what}: hot stage {u} did not move"
        flat = {name: _valid(got[name][k], spans) for name in ("adapter", "m_ad", "v_ad")}
        want = {name: _valid(end[name][k], spans) for name in ("adapter", "m_ad", "v_ad")}
        _close(flat["adapter"], want["adapter"], RTOL_GRAD, f"{what} adapters {k}",
               slack.layers(k))
        _close(flat["m_ad"], want["m_ad"], RTOL_GRAD, f"{what} m {k}")
        _close(flat["v_ad"], want["v_ad"], 2 * RTOL_GRAD, f"{what} v {k}")
    _close(got["m_hd"]["w"], end["m_hd"]["w"], RTOL_GRAD, f"{what} m head")
    _close(got["v_hd"]["w"], end["v_hd"]["w"], 2 * RTOL_GRAD, f"{what} v head")


def test_executor_matches_jax_executor_round_for_round(jax_run):
    """Balanced spans at lr 0, each round from the JAX executor's state after
    the last: the boundaries 6, 4, 2, all S losses, the tick ledger (packed
    at F = 3 and 2, the scan at F = 1), the adapters and head (in place on
    both sides), the adapters' moments, the step count and one build per
    boundary. After the first round the JAX executor's head moments are S
    and S^2 times the port's (the module docstring says why; at lr 0 they
    move no parameter, so every loss compares)."""
    ref = jax_run
    _, tcfg = _configs()
    ex = RingExecutor(tcfg, _tc(lr=EX_LR), _port_params(), S, M,
                      schedule=UnfreezeSchedule(depths=UNIFORM_DEPTHS, interval=S))
    start = _as_executor_state(_state(ref, "ex/start"), ref["ex/start/count"])
    mine = bridge.executor_state_to_jax(ex)
    for key in ("adapter", "head"):
        for k, v in start[key].items():
            np.testing.assert_array_equal(mine[key][k], v)
    for r in range(3):
        tag = "ex/start" if r == 0 else f"ex/r{r - 1}"
        begin, end = _state(ref, tag), _state(ref, f"ex/r{r}")
        bridge.executor_state_from_jax(_as_executor_state(begin, ref[f"{tag}/count"]), ex)
        rec = RingExecutor.materialize_metrics(
            ex.round(ref[f"ex/r{r}/tokens"], ref[f"ex/r{r}/labels"]))
        boundary = int(ref[f"ex/r{r}/boundary"])
        assert rec["boundary"] == boundary == (6, 4, 2)[r] and rec["step"] == S * (r + 1)
        for o, (a, b) in enumerate(zip(rec["losses"], ref[f"ex/r{r}/losses"], strict=True)):
            _close(a, b, RTOL_FWD, f"round {r} owner {o} loss")
        assert int(ex.opt_state["count"]) == int(ref[f"ex/r{r}/count"]) == S * (r + 1)
        F = 3 - r
        ledger = ex.measured_tick_ledger(boundary)
        assert ledger == json.loads(str(ref[f"ex/r{r}/ledger"]))
        assert ledger == pl.pipeline_tick_counts(S, M, boundary, 2, packed=F >= 2)
        got = _as_trainer_state(bridge.executor_state_to_jax(ex))
        for name in ("adapter", "head"):
            for k, v in got[name].items():
                np.testing.assert_array_equal(v, begin[name][k], err_msg=f"{name} {k}")
                np.testing.assert_array_equal(end[name][k], begin[name][k], err_msg=name)
        for k in ("w_down", "w_up"):
            for name, rtol in (("m_ad", RTOL_GRAD), ("v_ad", 2 * RTOL_GRAD)):
                np.testing.assert_array_equal(got[name][k][:F], begin[name][k][:F])
                np.testing.assert_array_equal(end[name][k][:F], begin[name][k][:F])
                _close(got[name][k], end[name][k], rtol, f"round {r} {name} {k}")
        if r == 0:
            for name, power in (("m_hd", 1), ("v_hd", 2)):
                mine = got[name]["w"]
                big = np.abs(mine) > 1e-3 * np.abs(mine).max()
                assert abs(np.median(end[name]["w"][big] / mine[big]) / S ** power - 1) < 1e-3, \
                    name
    assert ex.compile_counts() == json.loads(str(ref["ex/compile"])) == \
        {"2/direct": 1, "4/direct": 1, "6/direct": 1}
    assert ex.n_executables == 3


def test_ragged_walk_trainer_matches_jax_iteration_by_iteration(jax_run):
    """On [3, 2, 2, 1], boundaries 5 and 3: each owner iteration of the port's
    RingTrainer from the JAX RingTrainer's state before it, held to the
    state after it (loss, adapters, head, moments; frozen stages bit for
    bit)."""
    ref = jax_run
    _, tcfg = _configs()
    tc = _tc()
    tr = RingTrainer(tcfg, tc, _port_params(), S, M, spans=RAGGED,
                     schedule=UnfreezeSchedule(depths=RAGGED_DEPTHS, interval=S))
    assert tr.lps is None
    slack = _Slack(tc)
    _spy_trainer(tr, slack)
    for r in range(len(RAGGED_DEPTHS)):
        tokens, labels = tr.to_device(ref[f"tr/r{r}/tokens"], ref[f"tr/r{r}/labels"])
        boundary = int(ref[f"tr/r{r}/boundary"])
        assert tr.boundary_at(S * r) == boundary == (5, 3)[r]
        for owner in range(S):
            it = S * r + owner
            begin = _state(ref, f"tr/it{it}")
            bridge.ring_state_from_jax(begin, tr, device="cpu")
            tr.step = it
            slack.by_key.clear()
            loss, ticks = tr._iteration(owner, boundary, tokens, labels)
            _close(loss, ref["tr/losses"][it], RTOL_FWD, f"iteration {it} loss")
            _hold_round(bridge.ring_state_to_jax(tr), begin, _state(ref, f"tr/it{it + 1}"),
                        2 - r, slack, RAGGED, f"iteration {it}")


def test_ragged_walk_executor_matches_jax_round_by_round(jax_run):
    """On [3, 2, 2, 1], each round of the port's executor (packed at F = 2,
    the scan at F = 1) from the JAX RingTrainer's state at the round's start:
    the boundaries 5 and 3, the S losses, the frozen stages bit for bit, the
    tick ledger; and everything the round writes equal, bit for bit, to the
    port's RingTrainer over the same round from the same state."""
    ref = jax_run
    _, tcfg = _configs()
    tc = _tc()
    sched = UnfreezeSchedule(depths=RAGGED_DEPTHS, interval=S)
    ex = RingExecutor(tcfg, tc, _port_params(), S, M, spans=RAGGED, schedule=sched)
    tr = RingTrainer(tcfg, tc, _port_params(), S, M, spans=RAGGED, schedule=sched)
    for r in range(len(RAGGED_DEPTHS)):
        begin = _state(ref, f"tr/it{S * r}")
        bridge.executor_state_from_jax(_as_executor_state(begin, S * r), ex)
        bridge.ring_state_from_jax(begin, tr, device="cpu")
        data = (ref[f"tr/r{r}/tokens"], ref[f"tr/r{r}/labels"])
        rec, want = RingExecutor.materialize_metrics(ex.round(*data)), tr.round(*data)
        assert rec["boundary"] == want["boundary"] == int(ref[f"tr/r{r}/boundary"])
        assert rec["losses"] == [it["loss"] for it in want["iterations"]]
        for o, (a, b) in enumerate(zip(rec["losses"], ref["tr/losses"][S * r:S * (r + 1)],
                                       strict=True)):
            _close(a, b, RTOL_FWD, f"round {r} owner {o} loss")
        got, oracle = _as_trainer_state(bridge.executor_state_to_jax(ex)), \
            bridge.ring_state_to_jax(tr)
        F = 2 - r
        for name, tree in got.items():
            for k, v in tree.items():
                np.testing.assert_array_equal(v, oracle[name][k], err_msg=f"{name} {k}")
                if k in ("w_down", "w_up"):
                    np.testing.assert_array_equal(v[:F], begin[name][k][:F])
        F_eff = partition.frozen_stage_count(ex.spans, rec["boundary"])
        assert ex.measured_tick_ledger(rec["boundary"]) == \
            pl.pipeline_tick_counts(S, M, rec["boundary"], spans=RAGGED, packed=F_eff >= 2)


# ---------------------------------------------------------------- the executor alone


def test_frozen_stages_stay_bit_identical_and_hot_ones_move():
    _, tcfg = _configs()
    ex = RingExecutor(tcfg, _tc(), _port_params(), S, M, spans=RAGGED,
                      schedule=UnfreezeSchedule(depths=(3,), interval=S))
    F = partition.frozen_stage_count(ex.spans, ex.boundary_at(0))
    assert F == 2
    clone = lambda tree: [[{k: t.clone() for k, t in a.items()} for a in stage] for stage in tree]
    before = [clone(t) for t in (ex.stage_adapters(), ex.opt_state["m"]["adapter"],
                                 ex.opt_state["v"]["adapter"])]
    for r in range(2):
        ex.round(*_data(r))
    now = (ex.stage_adapters(), ex.opt_state["m"]["adapter"], ex.opt_state["v"]["adapter"])
    for was, tree in zip(before, now):
        for u in range(S):
            same = [torch.equal(a[k], b[k]) for a, b in zip(was[u], tree[u]) for k in a]
            assert all(same) if u < F else not any(same), (u, same)
    assert ex.compile_counts() == {"5/direct": 1}


def test_unpacked_executor_equals_packed():
    _, tcfg = _configs()
    sched = UnfreezeSchedule(depths=(2, 4), interval=S)
    runs = {}
    for packed in (True, False):
        ex = RingExecutor(tcfg, _tc(), _port_params(), S, M, packed=packed, schedule=sched)
        runs[packed] = [ex.round(*_data(r)) for r in range(2)]
        runs[packed].append(bridge.executor_state_to_jax(ex))
        assert ex.measured_tick_ledger(6) == pl.pipeline_tick_counts(S, M, 6, 2, packed=packed)
    for a, b in zip(runs[True][:2], runs[False][:2]):
        assert a["boundary"] == b["boundary"] and torch.equal(a["losses"], b["losses"])
    for key in ("adapter", "head"):
        for k, v in runs[True][2][key].items():
            np.testing.assert_array_equal(v, runs[False][2][key][k])


def test_a_rising_boundary_raises():
    class Rising:
        def depth_at(self, step, n_blocks):
            return 4 if step < S else 2

    _, tcfg = _configs()
    ex = RingExecutor(tcfg, _tc(), _port_params(), S, M, schedule=Rising())
    ex.round(*_data(0))
    with pytest.raises(RuntimeError, match="boundary increased 4 -> 6"):
        ex.round(*_data(1))


def test_repartition_mid_run_equals_a_run_started_on_the_new_layout():
    """14 layers: one round on the balanced [4, 4, 3, 3], then
    ``repartition([4, 5, 2, 3])`` and a second round, against an executor
    built on [4, 5, 2, 3] from the state after the first round."""
    _, tcfg = _configs(14)
    sched = UnfreezeSchedule(depths=(3,), interval=S)    # boundary 11 on both layouts
    shape = (S, 1, MB, 8)
    tc = TrainConfig(learning_rate=LR, n_microbatches=1, batch_size=MB, seq_len=8)
    ex = RingExecutor(tcfg, tc, _port_params(14), S, 1, schedule=sched)
    assert partition.span_sizes(ex.spans) == (4, 4, 3, 3)
    ex.round(*_data(0, shape))
    ex.repartition([4, 5, 2, 3])
    assert ex.spans == ((0, 4), (4, 9), (9, 11), (11, 14)) and ex.n_executables == 0
    other = RingExecutor(tcfg, tc, ex.export_params(), S, 1, spans=[4, 5, 2, 3],
                         schedule=sched)
    bridge.executor_state_from_jax(bridge.executor_state_to_jax(ex), other)
    other.step = ex.step
    got, want = ex.round(*_data(1, shape)), other.round(*_data(1, shape))
    assert got["boundary"] == want["boundary"] == 11
    assert torch.equal(got["losses"], want["losses"])
    a, b = bridge.executor_state_to_jax(ex), bridge.executor_state_to_jax(other)
    for key in ("adapter", "head"):
        for k, v in a[key].items():
            np.testing.assert_array_equal(v, b[key][k])
    assert ex.compile_counts() == {"11/direct": 2}


WALKS = {
    # the uniform walk of the JAX executor above: boundaries 6, 4, 2
    "uniform": (LAYERS, None, dict(unfreeze_interval=S), UNIFORM_DEPTHS, [6, 4, 2]),
    # the ragged walk on which the JAX executor and its RingTrainer split
    # (tests/test_partition_exec.py): 14 layers on [4, 5, 2, 3], initial depth
    # 3 and an interval of two rounds
    "split": (14, (4, 5, 2, 3), dict(unfreeze_interval=2 * S, initial_unfreeze_depth=3),
              None, [11, 11, 9, 9, 9, 9]),
}


@pytest.mark.parametrize("walk", sorted(WALKS))
def test_executor_equals_its_oracle_bit_for_bit(walk):
    """The port's executor and its RingTrainer on the same walk, round for
    round: the same boundaries, losses and parameters, bit for bit (the same
    operations on the same shapes, on the CPU)."""
    layers, spans, kw, depths, want = WALKS[walk]
    _, tcfg = _configs(layers)
    tc = TrainConfig(learning_rate=LR, n_microbatches=1, batch_size=MB, seq_len=8, **kw)
    sched = None if depths is None else UnfreezeSchedule(depths=depths, interval=S)
    ex = RingExecutor(tcfg, tc, _port_params(layers), S, 1, spans=spans, schedule=sched)
    tr = RingTrainer(tcfg, tc, _port_params(layers), S, 1, spans=spans, schedule=sched)
    walked = []
    for r in range(len(want)):
        data = _data(r, (S, 1, MB, 8))
        a, b = ex.round(*data), tr.round(*data)
        assert a["boundary"] == b["boundary"]
        assert a["losses"].tolist() == [it["loss"] for it in b["iterations"]]
        walked.append(a["boundary"])
    assert walked == want
    for x, y in zip(ex.export_params()["blocks"], tr.export_params()["blocks"]):
        assert all(torch.equal(x["adapter"][k], y["adapter"][k]) for k in x["adapter"])
    assert torch.equal(ex.shared["head"]["w"], tr.shared["head"]["w"])


def test_bridge_round_trips_ragged_ring_state():
    _, tcfg = _configs()
    rng = np.random.default_rng(4)
    fill = lambda t: t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    tr = RingTrainer(tcfg, _tc(), _port_params(), S, M, spans=RAGGED)
    for stage in tr.m_ad + tr.v_ad:
        for a in stage:
            for t in a.values():
                fill(t)
    state = bridge.ring_state_to_jax(tr)
    want = jax_pl.stack_entry(_jax_params()["blocks"][0]["adapter"], tr.spans)
    for k in want:
        np.testing.assert_array_equal(state["adapter"][k], np.asarray(want[k]))
    other = RingTrainer(tcfg, _tc(), _port_params(), S, M, spans=RAGGED)
    bridge.ring_state_from_jax(state, other, device="cpu")
    again = bridge.ring_state_to_jax(other)
    for key, tree in state.items():
        for k, v in tree.items():
            np.testing.assert_array_equal(again[key][k], v)

    ex = RingExecutor(tcfg, _tc(), _port_params(), S, M, spans=RAGGED)
    for t in [*(x for stage in ex.stage_adapters() for a in stage for x in a.values()),
              *ex.shared["head"].values()]:
        fill(t)
    for name in ("m", "v"):
        for stage in ex.opt_state[name]["adapter"]:
            for a in stage:
                for t in a.values():
                    fill(t)
    ex.opt_state["count"].fill_(12)
    state = bridge.executor_state_to_jax(ex)
    assert state["adapter"]["w_up"].shape[:2] == (S, 3)
    other = RingExecutor(tcfg, _tc(), _port_params(), S, M, spans=RAGGED)
    owned = [t.data_ptr() for stage in other.stage_adapters() for a in stage for t in a.values()]
    bridge.executor_state_from_jax(state, other)
    assert owned == [t.data_ptr() for stage in other.stage_adapters() for a in stage
                     for t in a.values()]
    again = bridge.executor_state_to_jax(other)
    for key in ("adapter", "head"):
        for k, v in state[key].items():
            np.testing.assert_array_equal(again[key][k], v)
    for name in ("m", "v"):
        for part in ("adapter", "head"):
            for k, v in state["opt_state"][name][part].items():
                np.testing.assert_array_equal(again["opt_state"][name][part][k], v)
    assert int(again["opt_state"]["count"]) == 12


# ---------------------------------------------------------------- the CLI


def test_fused_ring_cli_on_the_cpu(capsys):
    """``--mode ring`` alone runs the executor: one line per round, the
    boundary walking down, then the last round as JSON."""
    train.main(["--mode", "ring", "--arch", "stablelm-3b", "--reduced", "--layers", "4",
                "--stages", "2", "--rounds", "3", "--unfreeze-interval", "2",
                "--microbatches", "2", "--batch-size", "1", "--seq-len", "16",
                "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    lines = [ln.split() for ln in out if ln.startswith("round")]
    assert [ln[:6] for ln in lines] == [["round", "0", "boundary", "2", "depth", "2"],
                                        ["round", "1", "boundary", "2", "depth", "2"],
                                        ["round", "2", "boundary", "0", "depth", "4"]]
    assert all(np.isfinite(float(ln[7])) for ln in lines)
    last = json.loads(out[-1])
    assert (last["round"], last["boundary"], last["step"]) == (2, 0, 6)
    assert len(last["losses"]) == 2


@pytest.mark.parametrize("trainer", ["fused", "reference"])
def test_device_speeds_cli_prints_the_papers_spans(capsys, trainer):
    train.main(["--mode", "ring", "--trainer", trainer, "--arch", "stablelm-3b", "--reduced",
                "--layers", "14", "--stages", "4", "--rounds", "1", "--microbatches", "1",
                "--batch-size", "1", "--seq-len", "8", "--device-speeds",
                "1.0,1.25,0.5,0.75", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("heterogeneous ring: speeds [1.0, 1.25, 0.5, 0.75] -> spans "
                      "[[0, 4], [4, 9], [9, 11], [11, 14]]")
    assert json.loads(out[-1])["boundary"] == 11
    with pytest.raises(SystemExit, match="3 device speeds for a 4-stage ring"):
        train.main(["--mode", "ring", "--reduced", "--layers", "14", "--device-speeds",
                    "1,1,1", "--device", "cpu"])
