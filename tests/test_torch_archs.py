"""The four architectures of the slice against the JAX package, on the CPU:
starcoder2-7b (dense, a plain GELU MLP, 36 query heads over 4), olmoe-1b-7b
and moonshot-v1-16b-a3b (moe layers only) and llama4-maverick (dense and moe
layers interleaved).

  * each config copy equals the reference's, field for field, at full size
    and reduced, with the same parameter count;
  * the bridge carries every arch's weights and AdamW state both ways
    exactly, llama4's interleaved (dense, moe) pattern included: the port's
    layer i is the reference's pattern entry i mod 2 at repeat i // 2;
  * reduced starcoder2-7b's logits against the JAX package's (f32, 1e-5 of
    the largest entry; wq, wk and wv at the fan-in init as in
    tests/test_torch_ring.py, which says why);
  * one forward and one train step per arch at the reduced size, as
    tests/test_smoke_archs.py runs the JAX package's: shapes, finite values,
    only the hot adapters and the head moving;
  * the CLIs on the CPU: the serve CLI serves olmoe, the pjit train CLI
    prints moe_aux and moe_z on each step's line;
  * the ring on reduced olmoe with 4 layers (the port's seed weights), M = 2
    microbatches of 1 x 16 tokens: the fused ``RingExecutor`` held bit for bit
    to the port's ``RingTrainer`` on S = 4 stages of 1 at lr 1e-3
    (boundaries 3 and 0: the packed conveyor, then every stage hot), and at
    lr 0 to the JAX ``RingTrainer`` on S = 2 stages of 2 (one 2-host-device
    subprocess, XLA's optimisations off; it compiles one program per owner)
    for a round at boundary 2 (F = 1: the frozen moe layers in Phase A, the
    backward through the hot stage's two moe layers): the boundary, every
    owner's loss (1e-5) and the adapters' and head's moments (5e-4 of the
    largest entry for m, 1e-3 for v). At lr 0 no parameter moves, so the
    moments hold the gradients of every iteration without the raw Adam
    step's sign flips on gradients at f32's rounding
    (tests/test_torch_executor.py says why those compound); the updates at
    lr > 0 are the port's ``RingTrainer``'s, which tests/test_torch_ring.py
    holds to the JAX one on the dense ring;
  * the ring refusing llama4 (a stage applies one block kind to every layer).
"""
import dataclasses
import functools
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import params as jax_prm  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import RingSession  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core import training  # noqa: E402
from repro_torch.core.executor import RingExecutor  # noqa: E402
from repro_torch.core.ring import RingTrainer  # noqa: E402
from repro_torch.core.unfreeze import UnfreezeSchedule  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5              # f32: values, of the largest entry
RTOL_GRAD = 5e-4         # f32: moments through the layers, of the largest entry
STARCODER2, OLMOE, MOONSHOT, LLAMA4 = ("starcoder2-7b", "olmoe-1b-7b", "moonshot-v1-16b-a3b",
                                       "llama4-maverick-400b-a17b")
ARCHS = [STARCODER2, OLMOE, MOONSHOT, LLAMA4]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (many small ops; the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, dtype="float32", **kw):
    out = []
    for get in (jax_get_config, get_config):
        cfg = get(arch).reduced(dtype=dtype, **kw)
        out.append(dataclasses.replace(
            cfg, adapter=dataclasses.replace(cfg.adapter, zero_init_up=False)))
    return out


def _fan_in(p, cfg):
    """``p`` with wq, wk, wv at the fan-in scale 1/sqrt(d_model), in every
    pattern entry."""
    scale = np.sqrt(cfg.n_heads / cfg.d_model)
    return {**p, "blocks": tuple(
        {**e, "attn": {k: (v * scale).astype(v.dtype) if k in ("wq", "wk", "wv") else v
                       for k, v in e["attn"].items()}} for e in p["blocks"])}


def _close(got, want, rtol=RTOL, what=""):
    """max |got - want| <= rtol x max |want|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(jnp.asarray(got, jnp.float32))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max())
    assert gap <= rtol * scale, f"{what}: {gap} > {rtol} x {scale}"


# ---------------------------------------------------------------- configs and bridge


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    for make in (lambda g: g(arch), lambda g: g(arch).reduced()):
        jc, tc = make(jax_get_config), make(get_config)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert jc.param_count() == tc.param_count()
        assert (jc.padded_vocab, jc.out_dim) == (tc.padded_vocab, tc.out_dim)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_every_leaf(arch):
    """The port's seed weights (bf16) and a perturbed AdamW state to the
    reference's layout and back, exactly; the reference's tree has the
    leaves and shapes of its own ``param_defs``, and its pattern entries hold
    the port's layers in order (llama4: entry 0 the even, dense layers,
    entry 1 the odd, moe ones)."""
    jcfg, tcfg = _configs(arch, "bfloat16")
    port = prm.materialize(tcfg, seed=0, device="cpu")
    tree = bridge.params_to_jax(port, tcfg, bf16=jnp.bfloat16)
    defs = jax_prm.param_defs(jcfg)
    is_pd = lambda x: isinstance(x, jax_prm.PD)
    assert jax.tree.structure(defs, is_leaf=is_pd) == jax.tree.structure(tree)
    assert [pd.shape for pd in jax.tree.leaves(defs, is_leaf=is_pd)] == \
        [x.shape for x in jax.tree.leaves(tree)]
    per = len(tcfg.pattern)
    for i, layer in enumerate(port["blocks"]):
        kind = tcfg.pattern[i % per][0]
        entry = tree["blocks"][i % per]
        sub = "moe" if kind == "moe" else "ffn"
        for k, t in layer[sub].items():
            np.testing.assert_array_equal(bridge.to_numpy(t, jnp.bfloat16),
                                          entry[sub][k][i // per, 0])
    back = bridge.params_from_jax(tree, tcfg, device="cpu")
    for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(back), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    opt = adamw.init(training.full_trainable(port, tcfg))
    gen = torch.Generator().manual_seed(1)
    opt = {**jax.tree.map(lambda t: torch.randn(t.shape, generator=gen),
                          {k: opt[k] for k in ("m", "v")}), "count": opt["count"] + 3}
    again = bridge.opt_state_from_jax(bridge.opt_state_to_jax(opt, tcfg), tcfg, device="cpu")
    for a, b in zip(jax.tree.leaves(opt), jax.tree.leaves(again), strict=True):
        assert torch.equal(a, b)


def test_starcoder2_forward_matches_jax():
    """Reduced starcoder2-7b in f32 (a plain GELU MLP, 4 query heads over 2, a
    window of 128 over 160 tokens) on the JAX package's weights."""
    jcfg, tcfg = _configs(STARCODER2)
    jp = _fan_in(jax.tree.map(np.asarray, jax_prm.materialize(
        jax_prm.param_defs(jcfg), jax.random.key(0), jcfg.dtype)), jcfg)
    tp = bridge.params_from_jax(jp, tcfg, device="cpu")
    assert set(tp["blocks"][0]["ffn"]) == {"w_in", "w_out"}
    toks = np.random.default_rng(2).integers(0, 512, (2, 160)).astype(np.int32)
    want, _ = jax.jit(lambda t: jax_tfm.forward(jp, t, jcfg, impl="jnp"))(jnp.asarray(toks))
    got, aux = tfm.forward(tp, torch.from_numpy(toks).long(), tcfg)
    _close(got, want, what="logits")
    assert all(float(v) == 0.0 for v in aux.values())


# ---------------------------------------------------------------- smoke, as tests/test_smoke_archs.py


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_step_smoke(arch):
    cfg = get_config(arch).reduced()
    params = prm.materialize(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
             for k in ("tokens", "labels")}
    logits, aux = tfm.forward(params, batch["tokens"], cfg)
    assert logits.shape == (2, 64, cfg.out_dim) and not torch.isnan(logits.float()).any()
    assert set(aux) == {"moe_aux", "moe_z"} and all(torch.isfinite(v) for v in aux.values())
    boundary = cfg.repeats - 1                           # the top repeat unfrozen
    opt = adamw.init(training.full_trainable(params, cfg))
    new, _, m = training.make_train_step(cfg, TrainConfig(learning_rate=1e-3), boundary)(
        params, opt, batch)
    assert torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0
    assert ("moe_aux" in m) == any(k == "moe" for k, _ in cfg.pattern)
    n_frozen = boundary * cfg.layers_per_repeat
    for i, (a, b) in enumerate(zip(params["blocks"], new["blocks"])):
        moved = [not torch.equal(a["adapter"][k], b["adapter"][k]) for k in a["adapter"]]
        assert any(moved) if i >= n_frozen else not any(moved), (i, moved)
        assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a["ln1"]),
                                                     jax.tree.leaves(b["ln1"])))
    assert not torch.equal(params["head"]["w"], new["head"]["w"])
    assert torch.equal(params["embed"]["tok"], new["embed"]["tok"])


def test_cli_serves_olmoe_on_cpu(capsys):
    serve.main(["--arch", OLMOE, "--device", "cpu", "--requests", "3", "--slots", "2",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "on cpu" in out


def test_cli_pjit_prints_moe_metrics(capsys):
    train.main(["--mode", "pjit", "--arch", OLMOE, "--reduced", "--steps", "2",
                "--batch-size", "2", "--seq-len", "16", "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step ")]
    assert len(lines) == 2 and all(" moe_aux " in ln and " moe_z " in ln for ln in lines)


# ---------------------------------------------------------------- the ring

RS, RM, RMB, RSEQ, RLAYERS = 4, 2, 1, 16, 4
JS, JDEPTHS = 2, (2,)                    # the JAX ring: 2 stages of 2, boundary 2 (F = 1)


def _ring_configs():
    return _configs(OLMOE, n_layers=RLAYERS, repeats=RLAYERS)


@functools.lru_cache(maxsize=None)
def _ring_jax_params():
    """The port's seed weights in JAX's layout, wq, wk, wv at the fan-in scale."""
    cfg, tcfg = _ring_configs()
    return _fan_in(bridge.params_to_jax(prm.materialize(tcfg, seed=0, device="cpu"), tcfg), cfg)


def _ring_port_params():
    return bridge.params_from_jax(_ring_jax_params(), _ring_configs()[1], device="cpu")


def _ring_data(seed, stages=RS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (stages, RM, RMB, RSEQ)).astype(np.int32) for _ in range(2)]


def _ring_tc(lr):
    return TrainConfig(learning_rate=lr, n_microbatches=RM, batch_size=RMB, seq_len=RSEQ)


def test_fused_ring_equals_its_oracle_bit_for_bit():
    """The fused executor and RingTrainer on reduced olmoe, two rounds at lr
    1e-3 walking boundaries 3 and 0: the same boundaries, losses and
    parameters, bit for bit (the dispatch has no atomics and C comes from
    the shapes)."""
    _, tcfg = _ring_configs()
    sched = UnfreezeSchedule(depths=(1, 4), interval=RS)
    tc = _ring_tc(1e-3)
    ex = RingExecutor(tcfg, tc, _ring_port_params(), RS, RM, schedule=sched)
    tr = RingTrainer(tcfg, tc, _ring_port_params(), RS, RM, schedule=sched)
    walked = []
    for r in range(2):
        data = _ring_data(20 + r)
        a, b = ex.round(*data), tr.round(*data)
        assert a["boundary"] == b["boundary"]
        assert a["losses"].tolist() == [it["loss"] for it in b["iterations"]]
        walked.append(a["boundary"])
    assert walked == [3, 0]
    for x, y in zip(ex.export_params()["blocks"], tr.export_params()["blocks"]):
        assert all(torch.equal(x["adapter"][k], y["adapter"][k]) for k in x["adapter"])
    assert torch.equal(ex.shared["head"]["w"], tr.shared["head"]["w"])


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

src, out = sys.argv[1], sys.argv[2]
S, M, MB, SEQ, LAYERS, DEPTHS, SEEDS = {consts}
cfg = get_config("olmoe-1b-7b").reduced(n_layers=LAYERS, repeats=LAYERS, dtype="float32")
structure = jax.tree.structure(P.param_defs(cfg), is_leaf=lambda x: isinstance(x, P.PD))
arrays = np.load(src)
params = jax.tree.unflatten(structure,
                            [jnp.asarray(arrays[f"leaf{{i}}"]) for i in range(len(arrays.files))])
tc = TrainConfig(learning_rate=0.0, n_microbatches=M, batch_size=MB, seq_len=SEQ)
mesh = compat.make_mesh((S,), ("stage",))
res = {{}}
with compat.set_mesh(mesh):
    tr = RingTrainer(cfg, tc, mesh, params, S, M,
                     schedule=UnfreezeSchedule(depths=DEPTHS, interval=S))
    losses = []
    step = tr._iteration

    def iteration(*a):
        losses.append(step(*a))
        return losses[-1]

    tr._iteration = iteration
    for r, seed in enumerate(SEEDS):
        rng = np.random.default_rng(seed)
        tokens, labels = [rng.integers(0, 512, (S, M, MB, SEQ)).astype(np.int32)
                          for _ in range(2)]
        rec = tr.round(jnp.asarray(tokens), jnp.asarray(labels))
        res[f"r{{r}}/boundary"] = np.asarray(rec["boundary"])
        for name, tree in (("m_ad", tr.m_ad), ("v_ad", tr.v_ad), ("m_hd", tr.m_hd),
                           ("v_hd", tr.v_hd)):
            for k, v in tree.items():
                res[f"r{{r}}/{{name}}/{{k}}"] = np.asarray(v)
    res["losses"] = np.asarray(losses)
np.savez(out, **res)
"""

RING_SEEDS = (30,)


@pytest.fixture(scope="module")
def jax_ring(tmp_path_factory):
    """The JAX RingTrainer at lr 0 on the same weights, one round, in a
    2-host-device subprocess."""
    tmp = tmp_path_factory.mktemp("jax_moe_ring")
    src, out = tmp / "params.npz", tmp / "run.npz"
    np.savez(src, **{f"leaf{i}": x for i, x in enumerate(jax.tree.leaves(_ring_jax_params()))})
    code = _JAX_RING.format(consts=repr((JS, RM, RMB, RSEQ, RLAYERS, JDEPTHS, RING_SEEDS)))
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={JS}",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", code, str(src), str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(out))


def test_fused_ring_matches_jax_ring_trainer(jax_ring):
    """The port's fused executor at lr 0 against the JAX RingTrainer: the
    boundary, every owner's loss, the tick ledger and the moments after the
    round (the module docstring says why lr 0)."""
    ref = jax_ring
    _, tcfg = _ring_configs()
    ex = RingExecutor(tcfg, _ring_tc(0.0), _ring_port_params(), JS, RM,
                      schedule=UnfreezeSchedule(depths=JDEPTHS, interval=JS))
    for r, seed in enumerate(RING_SEEDS):
        rec = RingExecutor.materialize_metrics(ex.round(*_ring_data(seed, JS)))
        assert rec["boundary"] == int(ref[f"r{r}/boundary"]) == 2
        for o, (a, b) in enumerate(zip(rec["losses"], ref["losses"][JS * r:JS * (r + 1)],
                                       strict=True)):
            _close(a, b, what=f"round {r} owner {o} loss")
        assert ex.measured_tick_ledger(rec["boundary"]) == pl.pipeline_tick_counts(
            JS, RM, rec["boundary"], spans=ex.spans, packed=False)
        st = bridge.executor_state_to_jax(ex)
        o = st["opt_state"]
        for name, tree in (("m_ad", o["m"]["adapter"]), ("v_ad", o["v"]["adapter"]),
                           ("m_hd", o["m"]["head"]), ("v_hd", o["v"]["head"])):
            rtol = RTOL_GRAD if name.startswith("m") else 2 * RTOL_GRAD
            for k, v in tree.items():
                _close(v, ref[f"r{r}/{name}/{k}"], rtol, f"round {r} {name} {k}")


def test_the_ring_refuses_llama4():
    """Its dense and moe layers interleave, and a stage applies one block kind
    to every layer (the reference's ring does the same), so the ring refuses
    it with a ValueError that says so."""
    _, tcfg = _configs(LLAMA4)
    tc = TrainConfig(n_microbatches=1, batch_size=1, seq_len=8)
    with pytest.raises(ValueError, match="uniform layer pattern"):
        RingSession.create(tcfg, tc, backend="fused", n_stages=2, device="cpu")
    with pytest.raises(ValueError, match="uniform layer pattern"):
        RingExecutor(tcfg, tc, prm.materialize(tcfg, seed=0, device="cpu"), 1, 1)


@pytest.mark.parametrize("corrected", [False, True])
def test_a_large_leaf_updates_in_slices_bit_for_bit(corrected, monkeypatch):
    """AdamW updates an unmasked leaf above ``_SLICED_LEAF`` entries (llama4's
    head) a slice of rows at a time; the slices give the whole leaf's bits,
    ragged last slice included."""
    gen = torch.Generator().manual_seed(3)
    g, m, v, p = (torch.randn(37, 53, generator=gen) for _ in range(4))
    v, p = v.abs(), p.bfloat16()
    kw = dict(lr=torch.tensor(1e-3), tc=TrainConfig(),
              bias_correction=(torch.tensor(0.1), torch.tensor(0.001)) if corrected else None)
    whole = adamw.leaf_update(g, m, v, p, **kw)
    monkeypatch.setattr(adamw, "_SLICED_LEAF", 100)
    monkeypatch.setattr(adamw, "_SLICE", 5 * 53)
    sliced = adamw.leaf_update(g, m, v, p, **kw)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(whole, sliced))
