"""The port's RingSession facade against the JAX package's, on the CPU.

Reduced stablelm-3b (4 layers, d_model 128, d_ff 256) in f32, a ring of S =
4 stages (one layer a stage), M = 3 microbatches of 1 x 32 tokens per
client: tests/test_torch_actcache.py's shapes. The port materialises the
parameters from a seed and the bridge carries them to JAX's layout; in numpy
the adapters are then perturbed (W_up != 0) and wq, wk, wv scaled to the
fan-in init (tests/test_torch_ring.py says why). Both packages' sessions are
built on these same weights (``params=``): the port's random weights are not
JAX's, so two seed-built trunks would differ. Both draw their batches from
their own default data source, which gives the same tokens from the same seed.

  (a) the port's policies against the JAX package's over the reference's
      adversarial loss curves and policy grid (tests/test_api_session.py):
      every ``depth_at`` equal and ``state()`` JSON-equal at every step;
      the non-monotone ``ExplicitPolicy`` refusal and ``resolve_policy``'s
      names;
  (b) the checkpoint, both ways: a file the port writes (bf16 and f32
      leaves, non-trivial moments) restores bit for bit through the JAX
      ``checkpoint.restore`` / ``restore_opt``, and the reverse; a file
      without moments and a missing ``opt::`` key are refused;
  (c) sessions over rounds across boundary drops: the port's
      reference-backend session equals its bare ``RingTrainer`` bit for bit
      and matches the JAX ``ReferenceBackend`` session round for round
      (losses 1e-5 relative; the adapters, the head and their moments after
      the walk within 5e-4 of each leaf's largest entry, tests/test_torch_ring.py's
      gradient tolerance); the fused session equals the reference session
      bit for bit (the fused executor's CPU path is its oracle's); the cached
      session over the reference's 12-round, 2-slot walk equals the fused one
      bit for bit, hits ``[F, F, T, T] x 3``, 6 hits, 6 misses, 2
      invalidations; compile counts through the facade follow the
      reference's rule (fused: one a boundary; reference: S a boundary,
      ``RingTrainer.n_executables`` equal to the JAX ``RingTrainer``'s);
  (d) resume: fused, cached, reference and pjit sessions saved mid-run
      continue with losses ``==`` the uninterrupted run's and the same
      ``step_count`` and state; another format, another policy type and a
      rising boundary are refused;
  (e) across the packages: a JAX session saved after round 2, restored by
      the port's ``RingSession.restore(..., params=)``, runs rounds 3 and 4
      within (c)'s tolerances of the JAX session's own continuation, and a
      port-saved checkpoint restores into a JAX session whose state then
      equals the port's bit for bit;
  (f) the CLI: ``--save`` then ``--resume`` prints the losses of one
      uninterrupted run (reference, fused and cached rings, and pjit),
      ``--policy plateau`` runs, ``--scheme all_hot`` trains every layer from
      step 0, and ``--device-speeds`` with ``--resume`` is refused.

The JAX ring runs on four host devices, so its sessions run once for the
file in one subprocess (XLA's optimisations off).
"""
import functools
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._pytree import tree_leaves, tree_map  # noqa: E402

from repro.api import policies as jax_policies  # noqa: E402
from repro.checkpoint import checkpoint as jax_ckpt  # noqa: E402
from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.unfreeze import depth_to_boundary as jax_depth_to_boundary  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import (ExplicitPolicy, IntervalPolicy, LossPlateauPolicy,  # noqa: E402
                             RingSession, resolve_policy)
from repro_torch.api.data import RingDataSource  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core.partition import DeviceProfile  # noqa: E402
from repro_torch.core.ring import RingTrainer  # noqa: E402
from repro_torch.core.unfreeze import depth_to_boundary  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, M, MB, SEQ, LAYERS = 4, 3, 1, 32, 4
LR = 1e-3
RTOL_FWD = 1e-5          # the loss, relative
RTOL_STATE = 5e-4        # adapters, head, moments: of the leaf's largest entry
INTERVAL = 2 * S         # the boundary drops every second round: 3, 3, 2, 2, ...
JAX_ROUNDS, JAX_SAVED_AT = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (tests/test_torch_executor.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    kw = dict(n_layers=LAYERS, repeats=LAYERS, d_model=128, d_ff=256, dtype="float32")
    return jax_get_config("stablelm-3b").reduced(**kw), get_config("stablelm-3b").reduced(**kw)


def _tc(**kw):
    return TrainConfig(**{**dict(learning_rate=LR, n_microbatches=M, batch_size=MB,
                                 seq_len=SEQ, n_stages=S), **kw})


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The parameters in JAX's layout (numpy leaves, read only), the adapters
    perturbed from a numpy seed and wq, wk, wv at the fan-in scale."""
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


def _policy():
    return IntervalPolicy(initial_depth=1, interval=INTERVAL)


def _session(backend="fused", tc=None, **kw):
    kw = {"n_stages": S, "policy": _policy(), "params": _params(), "device": "cpu",
          "log": lambda *a: None, **kw}
    return RingSession.create(_configs()[1], tc or _tc(), backend=backend, **kw)


def _losses(sess, rounds):
    return [sess.step().materialize().loss for _ in range(rounds)]


def _state_np(sess):
    """The session's checkpoint state (the reference's layout) as flat numpy."""
    st = sess.backend.state()
    return {k: bridge.to_numpy(v) for k, v in ckpt._flatten({"params": st["params"],
                                                            "opt": st["opt"]}).items()}


def _assert_states_equal(a, b, what=""):
    assert a.keys() == b.keys(), what
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


# ---------------------------------------------------------------- (a) policies

N_BLOCKS = 8


def _adversarial_curves():
    rng = np.random.default_rng(0)
    curves = {
        "decreasing": [5.0 / (1 + 0.1 * i) for i in range(120)],
        "increasing": [1.0 + 0.1 * i for i in range(120)],
        "oscillating": [3.0 + 2.0 * math.sin(i) for i in range(120)],
        "constant": [2.0] * 120,
        "cliff_then_flat": [5.0] * 10 + [0.5] * 110,
        "nan_inf_mix": [float("nan"), float("inf"), 1.0, float("-inf"), 2.0,
                        float("nan")] * 20,
    }
    for s in range(3):
        curves[f"random_{s}"] = list(rng.normal(3.0, 2.0, size=120))
    return curves


POLICY_GRID = {
    "interval": ("IntervalPolicy", dict(initial_depth=1, interval=7)),
    "explicit": ("ExplicitPolicy", dict(depths=(1, 2, 2, 5, 8), interval=9)),
    "plateau_p1": ("LossPlateauPolicy", dict(initial_depth=1, patience=1, min_rel_improve=1e-2)),
    "plateau_p3": ("LossPlateauPolicy", dict(initial_depth=2, patience=3, min_rel_improve=1e-3,
                                             smoothing=0.9)),
}


@pytest.mark.parametrize("curve_name", sorted(_adversarial_curves()))
@pytest.mark.parametrize("policy_name", sorted(POLICY_GRID))
def test_policies_equal_jax(policy_name, curve_name):
    """Every depth, boundary and state() of the port's policy equals the JAX
    package's under the same loss curve; the depth never shrinks."""
    cls_name, kw = POLICY_GRID[policy_name]
    from repro_torch.api import policies
    mine, theirs = getattr(policies, cls_name)(**kw), getattr(jax_policies, cls_name)(**kw)
    jcfg, tcfg = (c.reduced(n_layers=N_BLOCKS, repeats=N_BLOCKS) for c in
                  (jax_get_config("stablelm-3b"), get_config("stablelm-3b")))
    prev = 0
    for step, loss in enumerate(_adversarial_curves()[curve_name]):
        d = mine.depth_at(step, N_BLOCKS)
        assert d == theirs.depth_at(step, N_BLOCKS) and d >= prev, (step, d)
        assert depth_to_boundary(tcfg, d) == jax_depth_to_boundary(jcfg, d)
        assert json.dumps(mine.state()) == json.dumps(theirs.state()), step
        mine.observe(step, loss)
        theirs.observe(step, loss)
        prev = d
    assert repr(mine) == repr(theirs)
    fresh = getattr(policies, cls_name)(**kw)
    fresh.load_state(json.loads(json.dumps(theirs.state())))
    assert fresh.depth_at(10 ** 6, N_BLOCKS) == theirs.depth_at(10 ** 6, N_BLOCKS)


def test_policy_refusals_and_names():
    with pytest.raises(ValueError, match="non-monotone"):
        ExplicitPolicy((1, 3, 2))
    tc = TrainConfig(unfreeze_interval=13)
    p = resolve_policy(None, tc)
    assert isinstance(p, IntervalPolicy) and p._sched.interval == 13
    assert isinstance(resolve_policy("interval", tc), IntervalPolicy)
    assert isinstance(resolve_policy("plateau", tc), LossPlateauPolicy)
    assert resolve_policy(p, tc) is p
    with pytest.raises(ValueError, match="unknown policy"):
        resolve_policy("nope", tc)
    want = jax_policies.resolve_policy("plateau", JaxTrainConfig(unfreeze_interval=13))
    assert json.dumps(resolve_policy("plateau", tc).state()) == json.dumps(want.state())


# ---------------------------------------------------------------- (b) the checkpoint


def _ckpt_trees(seed):
    """A trainable set in the reference's layout (bf16 adapters, an f32
    head) and non-trivial moments, as tensors."""
    _, tcfg = _configs()
    rng = np.random.default_rng(seed)
    rand = lambda shape, dt: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dt)
    p = prm.materialize(tcfg, seed=0, device="cpu")
    adapters = [{k: rand(t.shape, torch.bfloat16) for k, t in b["adapter"].items()}
                for b in p["blocks"]]
    params = bridge.trainable_to_reference(adapters, {"w": rand(p["head"]["w"].shape,
                                                                torch.float32)}, tcfg)
    spans = [(u, u + 1) for u in range(S)]
    moments = lambda: bridge.stage_layout([{k: rand(t.shape, torch.float32)
                                            for k, t in a.items()} for a in adapters], spans)
    opt = {k: {"adapter": bridge.stage_to_reference(moments(), tcfg, spans),
               "head": {"w": rand(p["head"]["w"].shape, torch.float32)}} for k in ("m", "v")}
    return params, {**opt, "count": torch.tensor(12, dtype=torch.int32)}


def _np_bits(x):
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    params, opt = _ckpt_trees(5)
    path = str(tmp_path / "port")
    ckpt.save(path, params, step=12, opt_state=opt, adapters_only=True, extra={"k": 1})
    jtree = lambda tree: jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.bfloat16
                                                          if t.dtype == torch.bfloat16
                                                          else jnp.float32 if t.is_floating_point()
                                                          else jnp.int32), tree)
    like = {"blocks": ({"adapter": jtree(params["blocks"][0]["adapter"]),
                        "attn": {"wq": jnp.ones((4, 1, 2))}},), "head": jtree(params["head"])}
    got, meta = jax_ckpt.restore(path, like)
    assert meta["step"] == 12 and meta["extra"] == {"k": 1} and meta["adapters_only"]
    np.testing.assert_array_equal(np.asarray(got["blocks"][0]["attn"]["wq"]), 1)   # not saved
    for k, t in params["blocks"][0]["adapter"].items():
        assert got["blocks"][0]["adapter"][k].dtype == jnp.bfloat16
        np.testing.assert_array_equal(_np_bits(got["blocks"][0]["adapter"][k]),
                                      bridge.to_numpy(t))
    np.testing.assert_array_equal(np.asarray(got["head"]["w"]), params["head"]["w"].numpy())
    jopt = jax_ckpt.restore_opt(path, jtree(opt))
    for k, t in ckpt._flatten(opt).items():
        path_k = k.split("::")
        leaf = functools.reduce(lambda tr, p: tr[p], path_k, jopt)
        np.testing.assert_array_equal(np.asarray(leaf), t.numpy())


def test_jax_checkpoint_restores_in_port_bit_for_bit(tmp_path):
    params, opt = _ckpt_trees(6)
    to_jax = lambda tree: jax.tree.map(
        lambda t: jnp.asarray(bridge.to_numpy(t, jnp.bfloat16)), tree)
    jparams = {"blocks": ({"adapter": to_jax(params["blocks"][0]["adapter"]),
                           "attn": {"wq": jnp.ones((4, 1, 2))}},),
               "head": to_jax(params["head"]), "final_norm": {"scale": jnp.ones((3,))}}
    path = str(tmp_path / "jax")
    jax_ckpt.save(path, jparams, step=7, opt_state=to_jax(opt), adapters_only=True)
    like = tree_map(torch.zeros_like, params)
    got, meta = ckpt.restore(path, like)
    assert meta["step"] == 7 and meta["has_opt_state"]
    for (k, a), (_, b) in zip(sorted(ckpt._flatten(got).items()),
                              sorted(ckpt._flatten(params).items()), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    got_opt = ckpt.restore_opt(path, tree_map(torch.zeros_like, opt))
    for (k, a), (_, b) in zip(sorted(ckpt._flatten(got_opt).items()),
                              sorted(ckpt._flatten(opt).items()), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_checkpoint_refuses_missing_moments(tmp_path):
    params, opt = _ckpt_trees(7)
    ckpt.save(str(tmp_path / "bare"), params, adapters_only=True)
    with pytest.raises(ValueError, match="no optimizer state"):
        ckpt.restore_opt(str(tmp_path / "bare"), opt)
    ckpt.save(str(tmp_path / "full"), params, opt_state={"m": opt["m"], "count": opt["count"]})
    with pytest.raises(KeyError, match="opt::v"):
        ckpt.restore_opt(str(tmp_path / "full"), opt)
    # the params path keeps a missing key's live value (the frozen trunk)
    got, _ = ckpt.restore(str(tmp_path / "full"), {**params, "embed": {"tok": torch.ones(2)}})
    assert torch.equal(got["embed"]["tok"], torch.ones(2))


# ---------------------------------------------------------------- the JAX sessions

_JAX_RUN = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_disable_most_optimizations", True)
from repro.api import IntervalPolicy, RingSession
from repro.configs import TrainConfig, get_config
from repro.models import params as P

src, out, ck_jax, ck_port = sys.argv[1:5]
S, M, MB, SEQ, LAYERS, LR, INTERVAL, ROUNDS, SAVED_AT = {consts}
cfg = get_config("stablelm-3b").reduced(n_layers=LAYERS, repeats=LAYERS, d_model=128, d_ff=256,
                                        dtype="float32")
structure = jax.tree.structure(P.param_defs(cfg), is_leaf=lambda x: isinstance(x, P.PD))
arrays = np.load(src)
params = jax.tree.unflatten(structure,
                            [jnp.asarray(arrays[f"leaf{{i}}"]) for i in range(len(arrays.files))])
tc = TrainConfig(learning_rate=LR, n_microbatches=M, batch_size=MB, seq_len=SEQ)
policy = lambda: IntervalPolicy(initial_depth=1, interval=INTERVAL)
quiet = lambda *a: None
res = {{}}

def dump(tag, sess):
    st = sess.backend.state()
    (e,) = st["params"]["blocks"]
    for k, v in e["adapter"].items():
        res[f"{{tag}}/params::blocks::0::adapter::{{k}}"] = np.asarray(v)
    res[f"{{tag}}/params::head::w"] = np.asarray(st["params"]["head"]["w"])
    for name in ("m", "v"):
        for part in ("adapter", "head"):
            for k, v in st["opt"][name][part].items():
                res[f"{{tag}}/opt::{{name}}::{{part}}::{{k}}"] = np.asarray(v)
    res[f"{{tag}}/opt::count"] = np.asarray(st["opt"]["count"])

sess = RingSession.create(cfg, tc, backend="reference", n_stages=S, policy=policy(),
                          params=params, log=quiet)
losses, bounds = [], []
for r in range(ROUNDS):
    m = sess.step().materialize()
    losses.append(m.loss)
    bounds.append(m.boundary)
    if r + 1 == SAVED_AT:
        sess.save(ck_jax)
dump("end", sess)
res["losses"], res["boundaries"] = np.asarray(losses), np.asarray(bounds)
res["compile_count"] = np.asarray(sess.backend.compile_count)
back = RingSession.restore(ck_port, cfg, tc, policy=policy(), params=params, log=quiet)
dump("port", back)
res["port_step"] = np.asarray(back.step_count)
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's reference-backend session over the JAX walk (saving after
    round 2, the file the JAX session restores), then the JAX sessions in one
    4-host-device subprocess."""
    tmp = tmp_path_factory.mktemp("jax_session")
    port_ck, jax_ck = str(tmp / "port_ck"), str(tmp / "jax_ck")
    sess = _session("reference")
    losses = []
    for r in range(JAX_ROUNDS):
        losses.append(sess.step().materialize().loss)
        if r + 1 == JAX_SAVED_AT:
            sess.save(port_ck)
            saved = _state_np(sess)
    src, out = tmp / "params.npz", tmp / "run.npz"
    np.savez(src, **{f"leaf{i}": x for i, x in enumerate(jax.tree.leaves(_jax_params()))})
    code = _JAX_RUN.format(consts=repr((S, M, MB, SEQ, LAYERS, LR, INTERVAL, JAX_ROUNDS,
                                        JAX_SAVED_AT)))
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={S}",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", code, str(src), str(out), jax_ck, port_ck],
                         env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return {"jax": dict(np.load(out)), "jax_ck": jax_ck, "port_losses": losses,
            "port_saved": saved, "port_end": _state_np(sess),
            "port_compiles": sess.backend.compile_count}


def _jax_state(jax_res, tag):
    return {k[len(tag) + 1:]: v for k, v in jax_res.items() if k.startswith(tag + "/")}


def _hold_state(got, want, what):
    assert got.keys() == want.keys(), (what, sorted(set(got) ^ set(want)))
    for k in want:
        if k == "opt::count":
            assert int(got[k]) == int(want[k]), what
        else:
            _close(got[k], want[k], RTOL_STATE, f"{what} {k}")


# ---------------------------------------------------------------- (c) sessions


def test_reference_session_equals_bare_ring_trainer():
    """The reference backend adds nothing to RingTrainer's arithmetic: the
    same batches, the same losses and state bit for bit."""
    _, tcfg = _configs()
    sess = _session("reference")
    bare = RingTrainer(tcfg, _tc(), _params(), S, M, schedule=_policy())
    data = RingDataSource(tcfg, _tc(), S)
    for _ in range(3):
        _, tokens, labels = data.next()
        want = bare.round(tokens, labels)
        got = sess.step().materialize()
        assert (got.loss, got.boundary, got.step) == (want["loss"], want["boundary"],
                                                      want["step"])
        assert got.extras["losses"] == [it["loss"] for it in want["iterations"]]
    d = sess.backend.driver
    for x, y in zip(tree_leaves((bare.stage_blocks, bare.m_ad, bare.v_ad, bare.m_hd, bare.v_hd,
                                 bare.shared)),
                    tree_leaves((d.stage_blocks, d.m_ad, d.v_ad, d.m_hd, d.v_hd, d.shared)),
                    strict=True):
        assert torch.equal(x, y)


def test_reference_session_matches_jax_round_for_round(runs):
    ref = runs["jax"]
    assert list(ref["boundaries"]) == [3, 3, 2, 2]
    for r, (got, want) in enumerate(zip(runs["port_losses"], ref["losses"], strict=True)):
        _close(got, want, RTOL_FWD, f"round {r} loss")
    _hold_state(runs["port_end"], _jax_state(ref, "end"), "after the walk")
    # one build per (owner, boundary), in both packages
    assert runs["port_compiles"] == int(ref["compile_count"]) == S * 2


def test_fused_session_equals_reference_session_bit_for_bit():
    ref, fused = _session("reference"), _session("fused")
    for _ in range(3):
        a, b = ref.step().materialize(), fused.step().materialize()
        assert (a.boundary, a.step, a.extras["losses"]) == \
            (b.boundary, b.step, b.extras["losses"])
        # the mean: the f32 mean of the owners' losses in both, as the reference's
        assert a.loss == b.loss == np.float32(b.loss)
    _assert_states_equal(_state_np(ref), _state_np(fused), "fused against reference")
    # the reference's rule: the fused backend builds once a boundary, the
    # reference backend S times
    assert (fused.backend.compile_count, ref.backend.compile_count) == (2, 2 * S)


def test_cached_session_equals_fused_over_the_slot_walk():
    """The reference's 12-round, 2-slot walk across two boundary drops
    (tests/test_api_session.py): hits [F, F, T, T] x 3, the cached session's
    losses and state the fused one's bit for bit."""
    tc = _tc()
    policy = lambda: IntervalPolicy(initial_depth=1, interval=4 * S)
    fused = _session("fused", slots_per_epoch=2, policy=policy(), tc=tc)
    cached = _session("cached", slots_per_epoch=2, policy=policy(), tc=tc)
    hits, bounds = [], []
    for _ in range(12):
        a, b = fused.step().materialize(), cached.step().materialize()
        assert (a.loss, a.extras["losses"], a.boundary) == (b.loss, b.extras["losses"],
                                                            b.boundary)
        hits.append(b.cache_hit)
        bounds.append(b.boundary)
    assert bounds == [3] * 4 + [2] * 4 + [1] * 4
    assert hits == [False, False, True, True] * 3
    st = cached.backend.driver.cache.stats()
    assert (st["cache_hits"], st["cache_misses"], st["cache_invalidations"]) == (6, 6, 2)
    _assert_states_equal(_state_np(fused), _state_np(cached), "cached against fused")
    assert cached.backend.compile_count == 3 * 2      # capture and cached, a boundary


# ---------------------------------------------------------------- (d) resume


@pytest.mark.parametrize("backend", ["fused", "cached", "reference", "pjit"])
def test_resumed_session_continues_bit_for_bit(tmp_path, backend):
    """Saved after 3 of 5 rounds (steps) and restored into a new session: the
    same losses, step count and state as the uninterrupted run. The cached
    session's round 3 is a hit in the uninterrupted run and a capture after
    the restore (the cache starts empty), which must not change a bit."""
    interval = {"cached": 4 * S, "pjit": 2}.get(backend, INTERVAL)
    kw = {"slots_per_epoch": 2} if backend == "cached" else {}
    tc = _tc()
    if backend == "pjit":
        kw, tc = {"n_stages": None}, _tc(batch_size=2)
    policy = lambda: IntervalPolicy(initial_depth=1, interval=interval)
    whole = _session(backend, tc=tc, policy=policy(), **kw)
    want = [whole.step().materialize() for _ in range(5)]
    part = _session(backend, tc=tc, policy=policy(), **kw)
    first = _losses(part, 3)
    path = str(tmp_path / backend)
    part.save(path)
    del part
    back = RingSession.restore(path, _configs()[1], tc, policy=policy(), params=_params(),
                               device="cpu", log=lambda *a: None)
    assert back.backend.name == backend and back.step_count == 3 * back.backend.steps_per_call
    rest = [back.step().materialize() for _ in range(2)]
    assert first + [m.loss for m in rest] == [m.loss for m in want]
    assert [m.boundary for m in rest] == [m.boundary for m in want[3:]]
    assert back.step_count == whole.step_count
    _assert_states_equal(_state_np(back), _state_np(whole), f"{backend} resumed")
    if backend == "cached":
        assert [m.cache_hit for m in want] == [False, False, True, True, False]
        assert [m.cache_hit for m in rest] == [False, False]


def test_restore_refuses_another_format_or_policy(tmp_path):
    sess = _session("fused")
    _losses(sess, 1)
    path = str(tmp_path / "fused")
    sess.save(path)
    common = dict(params=_params(), device="cpu", log=lambda *a: None)
    with pytest.raises(ValueError, match="format"):
        RingSession.restore(path, _configs()[1], _tc(), policy=_policy(), n_stages=2,
                            spans=None, **common)
    with pytest.raises(ValueError, match="format"):
        RingSession.restore(path, _configs()[1], _tc(), policy=_policy(), backend="pjit",
                            n_stages=None, **common)
    with pytest.raises(ValueError, match="policy"):
        RingSession.restore(path, _configs()[1], _tc(), policy="plateau", **common)


def test_session_refuses_a_rising_boundary():
    class Rising:
        wants_loss = False

        def depth_at(self, step, n_blocks):
            return 3 if step < S else 1          # the depth shrinks: the boundary rises

        def observe(self, step, loss):
            pass

    sess = _session("reference", policy=Rising())
    sess.step()
    with pytest.raises(RuntimeError, match="monotone"):
        sess.step()


def test_session_refuses_what_waits_for_later_items():
    # several tenants: the fused and cached backends take them, the reference
    # and pjit backends refuse them with the reference's messages
    assert _session("fused", tenants=2).n_tenants == 2
    cached = _session("cached", tenants=2, slots_per_epoch=2)
    assert cached.backend.driver.cache.capacity == 4 and cached.backend.format == "ring/S4/T2"
    with pytest.raises(ValueError, match="the reference oracle is single-tenant"):
        _session("reference", tenants=2)
    with pytest.raises(ValueError, match="tenants > 1 is a ring concept"):
        _session("pjit", tenants=2)
    # the elastic ring: pjit and the RingTrainer oracle refuse it with the
    # reference's messages
    with pytest.raises(ValueError, match="ring feature"):
        _session("pjit", elastic=True)
    with pytest.raises(NotImplementedError, match="fused"):
        _session("reference").backend.shrink(1, [DeviceProfile(1.0, math.inf)] * 3)
    with pytest.raises(ValueError, match="slots_per_epoch"):
        _session("cached")


def test_ring_formats_and_spans_equal_jax():
    """The backends' span resolution and format tags are the reference's:
    the balanced layout ``ring/S4``, the paper's speeds ``ring/S4/spans4-5-2-3``
    (14 blocks), and memory budgets charged at one block's weights."""
    from repro.api import backends as jax_backends
    from repro.core.partition import DeviceProfile as JaxProfile
    from repro_torch.api import backends
    from repro_torch.core.partition import DeviceProfile
    jcfg, tcfg = (c.reduced(n_layers=14, repeats=14) for c in
                  (jax_get_config("stablelm-3b"), get_config("stablelm-3b")))
    assert backends._block_weight_mb(tcfg) == jax_backends._block_weight_mb(jcfg)
    budgets = [(1.0, 6.0), (1.25, 4.0), (0.5, float("inf")), (0.75, 3.0)]   # MB: 4, 3, any, 2
    cases = [(None, None), ([1.0, 1.25, 0.5, 0.75], None), (None, [4, 5, 2, 3]),
             ([DeviceProfile(s, m) for s, m in budgets], None)]
    for speeds, spans in cases:
        jspeeds = speeds if not speeds or not isinstance(speeds[0], DeviceProfile) else \
            [JaxProfile(s, m) for s, m in budgets]
        assert backends._resolve_ring_spans(tcfg, S, spans, speeds) == \
            jax_backends._resolve_ring_spans(jcfg, S, spans, jspeeds)
    tags = [_session_format(tcfg, device_profiles=[1.0, 1.25, 0.5, 0.75]),
            _session_format(tcfg), _session_format(tcfg, backend="pjit", n_stages=None)]
    assert tags == ["ring/S4/spans4-5-2-3", "ring/S4", "pjit"]


def _session_format(cfg, backend="fused", **kw):
    kw = {"n_stages": S, "device": "cpu", "log": lambda *a: None, **kw}
    return RingSession.create(cfg, _tc(), backend=backend, **kw).backend.format


# ---------------------------------------------------------------- (e) across the packages


def test_port_resumes_a_jax_checkpoint(runs):
    """The JAX session saved after round 2; the port restores it on the same
    weights and runs rounds 3 and 4 within (c)'s tolerances of the JAX
    session's continuation."""
    ref = runs["jax"]
    back = RingSession.restore(runs["jax_ck"], _configs()[1], _tc(), policy=_policy(),
                               params=_params(), device="cpu", log=lambda *a: None)
    assert back.backend.name == "reference" and back.step_count == JAX_SAVED_AT * S
    # the restored state is the port's own after round 2 within the tolerance
    _hold_state(_state_np(back), runs["port_saved"], "restored")
    for r, got in enumerate(_losses(back, JAX_ROUNDS - JAX_SAVED_AT), JAX_SAVED_AT):
        _close(got, ref["losses"][r], RTOL_FWD, f"round {r} loss")
    _hold_state(_state_np(back), _jax_state(ref, "end"), "after the walk")
    # the fused backend reads the same file (the format is the ring's)
    fused = RingSession.restore(runs["jax_ck"], _configs()[1], _tc(), policy=_policy(),
                                backend="fused", params=_params(), device="cpu",
                                log=lambda *a: None)
    _assert_states_equal(_state_np(fused), _state_np(RingSession.restore(
        runs["jax_ck"], _configs()[1], _tc(), policy=_policy(), params=_params(),
        device="cpu", log=lambda *a: None)), "fused restore")


def test_jax_restores_a_port_checkpoint_bit_for_bit(runs):
    got = _jax_state(runs["jax"], "port")
    _assert_states_equal({k: v for k, v in got.items()}, runs["port_saved"], "JAX restore")
    assert int(runs["jax"]["port_step"]) == JAX_SAVED_AT * S


# ---------------------------------------------------------------- (f) the CLI

CLI = ["--mode", "ring", "--arch", "stablelm-3b", "--reduced", "--stages", "2",
       "--unfreeze-interval", "2", "--microbatches", "2", "--batch-size", "1",
       "--seq-len", "16", "--device", "cpu"]


def _round_lines(out):
    return [ln.split() for ln in out.splitlines() if ln.startswith(("round", "step"))]


def _key(line):
    """A printed line without its wall time and cache hit (a restored cache
    starts empty): round/step, boundary, depth, loss."""
    return [x for i, x in enumerate(line) if line[i - 1:i] not in (["round_ms"], ["cache_hit"])]


@pytest.mark.parametrize("extra", [["--trainer", "reference"], [], ["--slots-per-epoch", "2"],
                                   ["--mode", "pjit", "--unfreeze-interval", "2"]],
                         ids=["reference", "fused", "cached", "pjit"])
def test_cli_save_then_resume_prints_the_uninterrupted_losses(capsys, tmp_path, extra):
    pjit = "pjit" in extra
    args = (["--arch", "stablelm-3b", "--reduced", "--batch-size", "2", "--seq-len", "16",
             "--device", "cpu"] if pjit else CLI) + extra
    n = "--steps" if pjit else "--rounds"
    path = str(tmp_path / "ck")
    train.main(args + [n, "5"])
    whole = _round_lines(capsys.readouterr().out)
    train.main(args + [n, "3", "--save", path])
    first = _round_lines(capsys.readouterr().out)
    train.main(args + [n, "2", "--resume", path])
    out = capsys.readouterr().out
    rest = _round_lines(out)
    assert [_key(ln) for ln in first + rest] == [_key(ln) for ln in whole]
    assert len(whole) == 5 and rest[0][1] == "3"
    if not pjit:
        assert json.loads(out.splitlines()[-1])["round"] == 4


def test_cli_policy_scheme_and_refusals(capsys, tmp_path):
    train.main(CLI + ["--rounds", "3", "--policy", "plateau"])
    out = capsys.readouterr().out
    assert len(_round_lines(out)) == 3 and json.loads(out.splitlines()[-1])["step"] == 6
    train.main(["--arch", "stablelm-3b", "--reduced", "--batch-size", "2", "--seq-len", "16",
                "--device", "cpu", "--steps", "2", "--scheme", "all_hot"])
    lines = _round_lines(capsys.readouterr().out)
    assert [ln[:4] for ln in lines] == [["step", "0", "boundary", "0"],
                                        ["step", "1", "boundary", "0"]]
    path = str(tmp_path / "ck")
    train.main(CLI + ["--rounds", "1", "--save", path])
    with pytest.raises(ValueError, match="--device-speeds cannot be combined with --resume"):
        train.main(CLI + ["--rounds", "1", "--resume", path, "--device-speeds", "1,1"])
    with pytest.raises(ValueError, match="fixes the policy"):
        train.main(["--reduced", "--device", "cpu", "--scheme", "all_hot", "--policy",
                    "plateau"])
