"""The paper's own model, mbert-squad, in the port against the JAX package, on the CPU.

Reduced mbert-squad: d_model 256, 4 query heads over 4 KV heads (MHA, head_dim
64), d_ff 512, vocab 512, 2 layers, a learned position table of 4096 rows,
LayerNorm with biases, a non-gated GELU FFN with biases, adapter m 16 and the
span head [256, 2]; a GQA variant (2 KV heads) holds the other attention
path of the plain versions. The JAX package makes the parameters; in numpy
the adapters (W_up != 0), the LayerNorm scales and biases and the FFN biases
are then perturbed, so that none of them is an identity or a zero that would
hide a wrong leaf. Both packages get the same numpy batches. On the CPU the
port runs the plain versions of its kernels.

Tolerances (f32 unless said): ``layernorm`` 1e-6 of the output's largest
entry (the two frameworks' f32 means and variances sum in other orders);
the logits 5e-5 of their largest entry in f32 (tests/test_torch_train.py's
forward tolerance); in bf16 tests/test_torch_hymba.py's rule for bf16
logits: with the reference's own bf16-against-f32 RMS distance as the floor
(bf16 rounding's effect: 0.08 and 0.17 here, where the port's gap to the
reference's bf16 logits is 0.014 and 0.012), the port's RMS distance from the
reference's f32 logits within 1.25 floors and its gap to the bf16 logits
within one; ``qa_span_loss`` on the same logits: the
loss 1e-6 relative, its gradient 1e-6 of the largest entry, EM and F1
exactly (the same argmax spans, the same f32 formula). The steps: the loss
1e-5 relative; the adapters, the head and the moments after a step 5e-4 of
the leaf's largest entry, with tests/test_torch_train.py's slack of 2 lr a
step where a gradient entry lies within that gap of 0; the frozen layers'
leaves bit for bit; EM and F1 exactly where every row's argmax margin (start
and end) exceeds ten times the logits' tolerance, else within one row of a
batch (a flipped argmax). Checkpoints cross bit for bit.
"""
import dataclasses
import functools
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.api import IntervalPolicy as JaxIntervalPolicy  # noqa: E402
from repro.api import RingSession as JaxRingSession  # noqa: E402
from repro.api.backends import _default_params as jax_default_params  # noqa: E402
from repro.api.backends import _validate_ring as jax_validate_ring  # noqa: E402
from repro.api.data import PjitDataSource as JaxPjitDataSource  # noqa: E402
from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import training as jax_training  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import losses as jax_losses  # noqa: E402
from repro.models import params as jax_prm  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import IntervalPolicy, RingSession  # noqa: E402
from repro_torch.api.backends import PjitBackend, _validate_ring  # noqa: E402
from repro_torch.api.data import PjitDataSource  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import training  # noqa: E402
from repro_torch.core import unfreeze  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import blocks, losses  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCH = "mbert-squad"
RTOL_NORM = 1e-6          # layernorm, of the output's largest entry
RTOL_LOGITS = 5e-5        # f32 logits, of the largest logit
BF16_ACCURACY_RATIO = 1.25     # bf16 logits: RMS from the f32 reference, over the reference's
BF16_GAP_RATIO = 1.0           # bf16 logits: RMS to the bf16 reference, over the same
RTOL_FWD = 1e-5           # the step's loss, relative
RTOL_SPAN = 1e-6          # qa_span_loss on the same logits: loss (relative), gradient
RTOL_GRAD = 5e-4          # parameters and moments after a step, of the leaf's largest entry
B, S = 4, 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread_no_tf32():
    """One intra-op thread (the suite runs files in parallel) and no TF32."""
    n = torch.get_num_threads()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(n)
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _configs(dtype="float32", kv=None):
    kw = {"dtype": dtype} if kv is None else {"dtype": dtype, "n_kv_heads": kv}
    return jax_get_config(ARCH).reduced(**kw), get_config(ARCH).reduced(**kw)


@functools.lru_cache(maxsize=None)
def _jax_params(dtype="float32", kv=None):
    """JAX's parameters (numpy leaves, which no test writes to), the adapters,
    the LayerNorms and the FFN biases perturbed from a numpy seed."""
    cfg = _configs(dtype, kv)[0]
    p = jax.tree.map(np.asarray, jax_prm.materialize(jax_prm.param_defs(cfg),
                                                     jax.random.key(0), cfg.dtype))
    rng = np.random.default_rng(1)
    scale = {"w_down": 0.05, "w_up": 0.05, "scale": 0.1, "bias": 0.1, "b_in": 0.1, "b_out": 0.1}

    def perturb(path, v):
        s_ = scale.get(getattr(path[-1], "key", None))
        if s_ is None or path[0].key in ("embed", "head"):
            return v
        return (v.astype(np.float32) + s_ * rng.standard_normal(v.shape)).astype(v.dtype)

    return jax.tree_util.tree_map_with_path(perturb, p)


def _port_params(dtype="float32", kv=None):
    return bridge.params_from_jax(_jax_params(dtype, kv), _configs(dtype, kv)[1], device="cpu")


def _batch(seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, S - 4, B)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "starts": starts.astype(np.int32),
            "ends": (starts + rng.integers(0, 4, B)).astype(np.int32)}


def _close(got, want, rtol, what="", slack=None):
    """max |got - want| <= rtol x max |want|, plus ``slack`` elementwise."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(np.asarray(want).astype(np.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    excess = np.abs(got - want) - rtol * scale - (0.0 if slack is None else slack)
    assert float(excess.max()) <= 0, f"{what}: {float(np.abs(got - want).max())} > {rtol} x " \
        f"{scale} (+ slack) by {float(excess.max())}"


def _min_margin(logits) -> float:
    """The smallest gap between the two largest start or end logits of a row,
    over the largest logit's size."""
    lf = np.asarray(logits, np.float32)
    top2 = np.sort(lf, axis=1)[:, -2:, :]                  # [B, 2, 2]: rows, top two, start/end
    return float((top2[:, 1] - top2[:, 0]).min() / np.abs(lf).max())


# ---------------------------------------------------------------- the model's parts


def test_config_copy_matches_reference():
    """The port's copy field by field, full and reduced. The reduced config is
    MHA (4 query over 4 KV heads: reduced() keeps MHA an MHA), hd 64."""
    for pick in (lambda g: g(ARCH), lambda g: g(ARCH).reduced()):
        jc, tc = pick(jax_get_config), pick(get_config)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert jc.param_count() == tc.param_count()
        assert (jc.padded_vocab, jc.out_dim) == (tc.padded_vocab, tc.out_dim)
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff, full.vocab_size, full.padded_vocab, full.out_dim,
            full.adapter.bottleneck, full.max_seq_len) == \
        (12, 768, 12, 12, 64, 3072, 119547, 119552, 2, 48, 512)
    assert (full.rope, full.norm, full.glu, full.activation, full.head_out) == \
        (False, "layernorm", False, "gelu", 2)
    red = get_config(ARCH).reduced()
    assert (red.n_heads, red.n_kv_heads, red.head_dim, red.max_seq_len) == (4, 4, 64, 4096)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_every_leaf_exactly_both_ways(dtype):
    """The parameter tree (LayerNorm biases, FFN biases, the learned position
    table, the [D, 2] head) JAX -> port -> JAX bit for bit, and the trainable
    set and the moments after a JAX QA step through the checkpoint layout."""
    jcfg, tcfg = _configs(dtype)
    jp = _jax_params(dtype)
    tp = bridge.params_from_jax(jp, tcfg, device="cpu")
    layer = tp["blocks"][0]
    assert set(layer["ln1"]) == {"scale", "bias"} and set(layer["ffn"]) == \
        {"w_in", "b_in", "w_out", "b_out"}
    assert tp["embed"]["pos"].shape == (4096, 256) and tp["head"]["w"].shape == (256, 2)
    assert set(tp["final_norm"]) == {"scale", "bias"}
    back = bridge.params_to_jax(tp, tcfg, bf16=jnp.bfloat16)
    flat_j, tree_j = jax.tree.flatten(jp)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8), b.view(np.uint8))
    if dtype != "float32":             # the moments are f32 in both
        return
    # the trainable set and the moments in the checkpoint layout, after a JAX step
    jopt = jax_adamw.init(jax_training.full_trainable(jp))
    jp2, jopt, _ = jax.jit(jax_training.make_qa_train_step(jcfg, JaxTrainConfig(), 1))(
        jp, jopt, {k: jnp.asarray(v) for k, v in _batch().items()})
    tp2 = bridge.params_from_jax(jax.tree.map(np.asarray, jp2), tcfg, device="cpu")
    ref_params = bridge.trainable_to_reference([b["adapter"] for b in tp2["blocks"]],
                                               tp2["head"], tcfg)
    want = {"blocks": ({"adapter": jp2["blocks"][0]["adapter"]},), "head": jp2["head"]}
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(ref_params), strict=True):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      bridge.to_numpy(b).view(np.uint8))
    adapters, head = bridge.trainable_from_reference(ref_params, tcfg)
    assert all(torch.equal(a[k], b["adapter"][k]) for a, b in zip(adapters, tp2["blocks"])
               for k in a) and torch.equal(head["w"], tp2["head"]["w"])
    opt = bridge.opt_state_from_jax(jax.tree.map(np.asarray, jopt), tcfg, device="cpu")
    ref_opt = bridge.opt_state_to_reference(opt, tcfg)
    for a, b in zip(jax.tree.leaves(jopt), jax.tree.leaves(ref_opt), strict=True):
        np.testing.assert_array_equal(np.asarray(a), bridge.to_numpy(b))
    again = bridge.opt_state_from_reference(ref_opt, tcfg)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again), tree_leaves(opt)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """f32 inside, the population variance, rsqrt(var + 1e-5), scale and an
    optional bias; ``norm`` dispatches on cfg.norm as the reference's does."""
    rng = np.random.default_rng(2)
    x = (3.0 + 2.0 * rng.standard_normal((3, 7, 256))).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(256)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(256)).astype(np.float32)}
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.float().numpy()).astype(dtype)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for keys in (("scale", "bias"), ("scale",)):
        want = jax_blocks.layernorm({k: jnp.asarray(p[k]) for k in keys}, jx)
        got = blocks.layernorm({k: tp[k] for k in keys}, tx)
        assert got.dtype == tx.dtype
        if dtype == "float32":
            _close(got, want, RTOL_NORM, f"layernorm {keys}")
        else:     # one bf16 ulp where the f32 results round on either side
            _close(got, np.asarray(want.astype(jnp.float32)), 2.0 ** -7, f"layernorm {keys}")
    for arch in (ARCH, "stablelm-3b"):
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
        want = jax_blocks.norm(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
        _close(blocks.norm(tcfg, tp, torch.from_numpy(x)), want, RTOL_NORM, f"norm {arch}")


@pytest.mark.parametrize("kv", [None, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_span_logits_match_jax(dtype, kv):
    """``forward``'s [B, S, 2] logits (causal, as the reference runs mBERT;
    learned positions; no vocab mask on a span head) at boundaries 0 and 1."""
    jcfg, tcfg = _configs(dtype, kv)
    jp = _jax_params(dtype, kv)
    tp = bridge.params_from_jax(jp, tcfg, device="cpu")
    tokens = _batch()["tokens"]
    rms = lambda x: float(np.sqrt(np.mean(np.square(x))))
    for boundary in (0, 1):
        want, _ = jax_tfm.forward(jp, jnp.asarray(tokens), jcfg, boundary=boundary, impl="jnp")
        got = tfm.forward(tp, torch.from_numpy(tokens).long(), tcfg, boundary=boundary)
        assert got.shape == (B, S, 2) and got.dtype == getattr(torch, dtype)
        if dtype == "float32":
            _close(got, want, RTOL_LOGITS, f"logits at boundary {boundary}")
            continue
        # the reference in f32 on the same (bf16-valued) weights
        jp32 = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
        want32, _ = jax_tfm.forward(jp32, jnp.asarray(tokens), _configs("float32", kv)[0],
                                    boundary=boundary, impl="jnp")
        got, want, want32 = (np.asarray(x, np.float32) for x in
                             (got.float().numpy(), want.astype(jnp.float32), want32))
        floor = rms(want - want32)                 # bf16 rounding's own effect
        assert rms(got - want32) <= BF16_ACCURACY_RATIO * floor, (rms(got - want32), floor)
        assert rms(got - want) <= BF16_GAP_RATIO * floor, (rms(got - want), floor)


def test_qa_span_loss_matches_jax():
    """Loss, EM and F1 on the same logits: random spans, exact hits, ties
    (the first maximum wins in both), spans with no overlap and a predicted
    end before its start; and the loss's gradient against jax.grad."""
    rng = np.random.default_rng(3)
    n, seq = 8, 16
    logits = rng.standard_normal((n, seq, 2)).astype(np.float32)
    starts = rng.integers(0, seq - 4, n).astype(np.int32)
    ends = (starts + rng.integers(0, 4, n)).astype(np.int32)
    logits[0, :, :] = 0.0                        # all tied: argmax 0 for start and end
    logits[1, starts[1], 0] = logits[1, ends[1], 1] = 9.0      # an exact hit
    logits[2, [3, 7], 0] = 9.0                   # a tie between two starts
    logits[3, :, 0] = -5.0                       # no overlap: the prediction after the gold
    logits[3, seq - 1, 0] = logits[3, seq - 1, 1] = 5.0
    logits[4, 10, 0], logits[4, 2, 1] = 9.0, 9.0    # the predicted end before its start
    jl, jm = jax_losses.qa_span_loss(jnp.asarray(logits), jnp.asarray(starts), jnp.asarray(ends))
    lt = torch.from_numpy(logits).requires_grad_(True)
    tl, tm = losses.qa_span_loss(lt, torch.from_numpy(starts), torch.from_numpy(ends))
    assert set(tm) == {"loss", "em", "f1"}
    _close(tl, jl, RTOL_SPAN, "loss")
    assert 0 < float(jm["em"]) < 1 and 0 < float(jm["f1"]) < 1
    assert float(tm["em"]) == float(jm["em"]) and float(tm["f1"]) == float(jm["f1"])
    jg = jax.grad(lambda x: jax_losses.qa_span_loss(x, jnp.asarray(starts),
                                                    jnp.asarray(ends))[0])(jnp.asarray(logits))
    (tg,) = torch.autograd.grad(tl, lt)
    _close(tg, jg, RTOL_SPAN, "loss gradient")


# ---------------------------------------------------------------- the QA step


def test_qa_train_steps_with_walking_boundary_match_jax():
    """Depths 1, 1, 2 at interval 1 (the boundary walks 1 -> 1 -> 0) through
    ``make_step`` (the QA step for a span head) against the reference's
    ``make_qa_train_step``: loss, EM, F1, the hot adapters, the head and the
    moments after each step; the frozen layer's leaves bit for bit."""
    jcfg, tcfg = _configs()
    jtc, tc = JaxTrainConfig(warmup_steps=2), TrainConfig(warmup_steps=2)
    jp = jax.tree.map(jnp.asarray, _jax_params())
    tp = _port_params()
    jopt = jax_adamw.init(jax_training.full_trainable(jp))
    opt = adamw.init(training.full_trainable(tp, tcfg))
    segs = unfreeze.boundary_schedule(tcfg, unfreeze.UnfreezeSchedule(depths=(1, 1, 2),
                                                                      interval=1), 3)
    assert segs == [(0, 2, 1), (2, 3, 0)]
    slack = {}
    jforward = jax.jit(lambda p, tokens: jax_tfm.forward(p, tokens, jcfg, impl="jnp")[0])

    def add_slack(key, m_old, m_new, lr):
        g = (np.asarray(m_new) - jtc.beta1 * np.asarray(m_old)) / (1 - jtc.beta1)
        near0 = np.abs(g) <= RTOL_GRAD * np.abs(g).max()
        slack[key] = slack.get(key, 0.0) + np.where(near0, 2 * lr, 0.0)
    for start, end, boundary in segs:
        jstep = jax.jit(jax_training.make_qa_train_step(jcfg, jtc, boundary))
        step = training.make_step(tcfg, tc, boundary)
        for s in range(start, end):
            batch = _batch(seed=10 + s)
            jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
            margin = _min_margin(jforward(jp, jbatch["tokens"]))
            frozen = [{k: t.clone() for k, t in tree.items()} for i in range(boundary)
                      for tree in (tp["blocks"][i]["adapter"], opt["m"]["adapters"][i],
                                   opt["v"]["adapters"][i])]
            jm_old = jopt["m"]
            jp, jopt, jm = jstep(jp, jopt, jbatch)
            tp, opt, m = step(tp, opt, pipeline.to_device(batch, "cpu"))
            assert set(m) == {"loss", "em", "f1"}
            _close(m["loss"], jm["loss"], RTOL_FWD, f"step {s} loss")
            for key in ("em", "f1"):
                if margin > 10 * RTOL_LOGITS:
                    assert float(m[key]) == float(jm[key]), (s, key)
                else:
                    assert abs(float(m[key]) - float(jm[key])) <= 1.0 / B, (s, key)
            lr = float(jax_adamw.lr_at(jtc, jopt["count"]))
            add_slack("head", jm_old["head"]["w"], jopt["m"]["head"]["w"], lr)
            _close(tp["head"]["w"], jp["head"]["w"], RTOL_GRAD, f"step {s} head", slack["head"])
            for i, b in enumerate(tp["blocks"]):
                for leaf, t in b["adapter"].items():
                    if i >= boundary:
                        add_slack((i, leaf), jm_old["adapters"][0][leaf][i, 0],
                                  jopt["m"]["adapters"][0][leaf][i, 0], lr)
                    _close(t, jp["blocks"][0]["adapter"][leaf][i, 0], RTOL_GRAD,
                           f"step {s} layer {i} {leaf}", slack.get((i, leaf)))
            now = [tree for i in range(boundary)
                   for tree in (tp["blocks"][i]["adapter"], opt["m"]["adapters"][i],
                                opt["v"]["adapters"][i])]
            assert all(torch.equal(a[k], b[k]) for a, b in zip(now, frozen) for k in a)
            assert int(opt["count"]) == int(jopt["count"]) == s + 1
    back = bridge.opt_state_to_jax(opt, tcfg)
    for k, rtol in (("m", RTOL_GRAD), ("v", 2 * RTOL_GRAD)):
        _close(back[k]["head"]["w"], jopt[k]["head"]["w"], rtol, f"{k} head")
        for leaf in ("w_down", "w_up"):
            _close(back[k]["adapters"][0][leaf], jopt[k]["adapters"][0][leaf], rtol,
                   f"{k} adapters {leaf}")
    with pytest.raises(ValueError, match="span head"):
        training.make_qa_train_step(get_config("stablelm-3b").reduced(), tc, 0)


# ---------------------------------------------------------------- data, session, checkpoint


def test_pjit_data_source_yields_the_reference_qa_batches():
    jcfg, tcfg = _configs()
    jtc, tc = JaxTrainConfig(batch_size=3, seq_len=S), TrainConfig(batch_size=3, seq_len=S)
    jd, td = JaxPjitDataSource(jcfg, jtc), PjitDataSource(tcfg, tc)
    for _ in range(3):
        want, got = jd.next(), td.next()
        assert set(got) == set(want) == {"tokens", "starts", "ends"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        assert (got["starts"] <= got["ends"]).all()
    assert td.state() == jd.state()
    td2 = PjitDataSource(tcfg, tc)
    td2.load_state(jd.state())
    np.testing.assert_array_equal(td2.next()["starts"], jd.next()["starts"])


def _seq_tc(jax_side=False, **kw):
    kw = {"batch_size": B, "seq_len": S, "unfreeze_interval": 2, "warmup_steps": 2, **kw}
    return JaxTrainConfig(**kw) if jax_side else TrainConfig(**kw)


def test_pjit_session_matches_reference_train_pjit():
    """The reference's ``train_pjit`` on its seed weights and the port's pjit
    ``RingSession`` on the same weights: 4 steps across the boundary drop
    (1, 1, 0, 0); loss, EM and F1 in the history and the log line (the
    reference's ``acc/f1=`` is F1), one build a boundary."""
    jcfg, tcfg = _configs()
    jtc, tc = _seq_tc(True), _seq_tc()
    jlines = []
    ref = jax_train.train_pjit(jcfg, jtc, steps=4, log_every=1, log=jlines.append)
    jparams = jax.tree.map(np.asarray, jax_default_params(jcfg, jtc))
    lines = []
    sess = RingSession.create(tcfg, tc, backend="pjit", device="cpu", log=lines.append,
                              params=bridge.params_from_jax(jparams, tcfg, device="cpu"))
    got = sess.run(4, callbacks=[train.LoggingCallback(lines.append)])
    assert [h["boundary"] for h in got] == [h["boundary"] for h in ref["history"]] == \
        [1, 1, 0, 0]
    for h, r in zip(got, ref["history"]):
        _close(h["loss"], r["loss"], RTOL_FWD, f"step {h['step']} loss")
        assert (h["em"], h["f1"], h["step"]) == (pytest.approx(r["em"], abs=0),
                                                 pytest.approx(r["f1"], abs=0), r["step"])
        assert "grad_norm" not in h and h["compile_count"] == r["compile_count"]
    assert got[-1]["compile_count"] == 2
    jf1 = [float(re.search(r"acc/f1=([0-9.]+)", ln).group(1)) for ln in jlines if "acc/f1" in ln]
    f1 = [float(ln.split()[-1]) for ln in lines if ln.startswith("step")]
    assert [ln.split()[:4] for ln in lines if ln.startswith("step")][0] == \
        ["step", "0", "boundary", "1"]
    assert [round(x, 3) for x in f1] == jf1 and len(f1) == 4


def test_qa_checkpoint_crosses_both_ways(tmp_path):
    """A port pjit QA session saved after 2 steps restores in the JAX package
    with the same adapters, head and moments bit for bit, and the reverse;
    ``load_state`` copies into the backend's own tensors (on the card its
    graphs read them), and both continue with the same loss."""
    jcfg, tcfg = _configs()
    jtc, tc = _seq_tc(True), _seq_tc()
    jp = _jax_params()
    policy = lambda: IntervalPolicy(initial_depth=1, interval=2)
    jpolicy = lambda: JaxIntervalPolicy(initial_depth=1, interval=2)
    quiet = lambda *a: None
    sess = RingSession.create(tcfg, tc, backend="pjit", policy=policy(), device="cpu",
                              params=bridge.params_from_jax(jp, tcfg, device="cpu"), log=quiet)
    ptrs = [t.data_ptr() for t in sess.backend.state_tensors()]
    sess.run(2)
    assert [t.data_ptr() for t in sess.backend.state_tensors()] == ptrs
    path = str(tmp_path / "port")
    sess.save(path)
    jsess = JaxRingSession.restore(path, jcfg, jtc, policy=jpolicy(), backend="pjit",
                                   impl="jnp", params=jax.tree.map(jnp.asarray, jp), log=quiet)
    st = sess.backend.state()
    jst = jsess.backend.state()
    want = {"blocks": ({"adapter": jst["params"]["blocks"][0]["adapter"]},),
            "head": jst["params"]["head"]}
    for a, b in zip(jax.tree.leaves((want, jst["opt"])),
                    jax.tree.leaves((st["params"], st["opt"])),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), bridge.to_numpy(b))
    assert jsess.step_count == sess.step_count == 2
    # the reverse: the JAX session one step on, saved, restored by the port
    jloss = float(jsess.step().materialize().loss)
    jpath = str(tmp_path / "jax")
    jsess.save(jpath)
    back = RingSession.restore(jpath, tcfg, tc, policy=policy(), device="cpu", log=quiet,
                               params=bridge.params_from_jax(jp, tcfg, device="cpu"))
    ptrs = [t.data_ptr() for t in back.backend.state_tensors()]
    jst = jsess.backend.state()
    want = {"blocks": ({"adapter": jst["params"]["blocks"][0]["adapter"]},),
            "head": jst["params"]["head"]}
    st = back.backend.state()
    for a, b in zip(jax.tree.leaves((want, jst["opt"])),
                    jax.tree.leaves((st["params"], st["opt"])),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), bridge.to_numpy(b))
    assert back.step_count == 3
    # the port's own continuation from step 2 gives the JAX step's loss
    _close(sess.step().materialize().loss, jloss, RTOL_FWD, "step 3 loss")
    back.step()
    assert [t.data_ptr() for t in back.backend.state_tensors()] == ptrs


def test_ring_backends_refuse_a_task_head():
    jcfg, tcfg = _configs()
    with pytest.raises(ValueError) as want:
        jax_validate_ring(jcfg, 2)
    with pytest.raises(ValueError) as got:
        _validate_ring(tcfg, 2)
    assert str(got.value) == str(want.value)
    for backend, kw in (("fused", {}), ("cached", {"slots_per_epoch": 2}), ("reference", {})):
        with pytest.raises(ValueError, match="task head"):
            RingSession.create(tcfg, TrainConfig(), backend=backend, n_stages=2, device="cpu",
                               log=lambda *a: None, **kw)
    assert isinstance(RingSession.create(tcfg, TrainConfig(), backend="pjit", device="cpu",
                                         log=lambda *a: None).backend, PjitBackend)


def test_cli_trains_mbert_squad_by_default_on_the_cpu(capsys):
    """No --arch: the reference's default, mbert-squad, with the QA loss: one
    line a step with its boundary, loss, EM and F1; the ring refuses it."""
    train.main(["--mode", "pjit", "--reduced", "--steps", "3", "--unfreeze-interval", "2",
                "--batch-size", "2", "--seq-len", "16", "--device", "cpu"])
    lines = [ln.split() for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert [ln[:4] for ln in lines] == [["step", "0", "boundary", "1"],
                                        ["step", "1", "boundary", "1"],
                                        ["step", "2", "boundary", "0"]]
    assert all(ln[4::2] == ["loss", "em", "f1"] and np.isfinite(float(ln[5])) for ln in lines)
    with pytest.raises(ValueError, match="task head"):
        train.main(["--mode", "ring", "--reduced", "--stages", "2", "--rounds", "1",
                    "--device", "cpu"])
