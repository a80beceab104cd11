"""Training rwkv6-7b in the port against the JAX package, on the CPU.

The pieces first: the plain backward of the wkv recurrence
(``ref.rwkv_scan_bwd``, the yardstick of the backward kernel on the card)
against ``jax.vjp`` of the reference's sequential oracle
(``repro.kernels.ref.rwkv_scan``) and of its chunked jnp scan
(``blocks._wkv_chunk`` over chunks, as ``rwkv_time_mix`` runs it), every
input's gradient included (``du``, ``dstate0``); the backward kernel's
arithmetic emulated on the CPU (its Phi walk for dlw, which never needs the
state and the cotangent at one step); the ``autograd.Function`` of
``ops.rwkv_scan`` against autograd through the plain forward. Then the time
mix's gradients against ``jax.vjp`` of the reference's, and the port's LM
step on a reduced rwkv6-7b (2 layers, d 256, 8 heads of 32, adapter m 16,
f32, weights made by JAX and carried by the bridge, W_up != 0) against the
JAX package's ``make_train_step`` over 3 steps with a walking boundary. Last,
the ring's refusal of the recurrent kinds and the pjit CLI.

Tolerances, each with its reason:

- The plain backward against ``jax.vjp``: 1e-5 of each gradient's largest
  entry (f32 sums in another order along the recurrence).
- The kernel's arithmetic, emulated in f32, against the plain backward in
  f64: 1e-5 of each gradient's largest entry (measured below 1e-6 at the
  served scale: r, k, v of std 8, decays down to -20 a step, a start state of
  std 100).
- The ``autograd.Function`` against autograd through the plain forward:
  1e-5 of each gradient's largest entry.
- The time mix's input and weight gradients: 1e-4 of each gradient's largest
  entry (f32 through the group norm, the gate and five projections, summed in
  another order in each framework).
- The 3-step walk: the tolerances of
  ``tests/test_torch_train.py::test_three_train_steps_with_walking_boundary_match_jax``:
  the loss 1e-5 relative, the gradient norm, the head and the adapters after
  each step 5e-4 of the leaf's largest entry (plus 2 lr a step where a
  gradient entry lies within that gap of 0, where Adam may move either way),
  the frozen layer's adapter and moments bit for bit.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import training as jax_training  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import params as jax_prm  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import RingSession  # noqa: E402
from repro_torch.api import backends  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import pipeline, training, unfreeze  # noqa: E402
from repro_torch.core.ring import RingTrainer  # noqa: E402
from repro_torch.data import pipeline as data_pipeline  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

SCAN_RTOL = 1e-5       # plain backward vs jax.vjp; the kernel's emulation; the Function
MIX_RTOL = 1e-4        # the time mix's gradients, of each gradient's largest entry
RTOL_FWD = 1e-5        # the walk: the loss, relative
RTOL_GRAD = 5e-4       # the walk: gradients and parameters, of the leaf's largest entry
B, S = 2, 24           # the walk's batches


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tests run many small ops (the
    plain scans step by step), which a thread per core slows many times over
    when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, rtol, what="", slack=None):
    """max |got - want| <= rtol x max |want|, plus ``slack`` elementwise."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    excess = np.abs(got - want) - rtol * scale - (0.0 if slack is None else slack)
    assert float(excess.max()) <= 0, f"{what}: {float(np.abs(got - want).max())} > {rtol} x " \
        f"{scale} (+ slack) by {float(excess.max())}"


def _scan_inputs(N, S_, hd, seed, scale=1.0, strong=False, state=True):
    """r, k, v of std ``scale``, log decays -exp(x) with x uniform in the decay
    prior's (-6, -0.5) (``strong``: up to 3, decays down to -20 a step), u of
    std 0.5, a start state of std ``scale`` ** 2 (or zero) and dout."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    r, k, v = f(N, S_, hd, sc=scale), f(N, S_, hd, sc=scale), f(N, S_, hd, sc=scale)
    top = 3.0 if strong else -0.5
    lw = -np.exp(rng.uniform(-6.0, top, (N, S_, hd))).astype(np.float32)
    u = f(N, 1, hd, sc=0.5)
    s0 = f(N, hd, hd, sc=scale ** 2) if state else np.zeros((N, hd, hd), np.float32)
    return r, k, v, lw, u, s0, f(N, S_, hd)


NAMES = ("dr", "dk", "dv", "dlw", "du", "dstate0")


@pytest.mark.parametrize("N,S_,hd,state", [(2, 9, 8, True), (3, 33, 16, False),
                                           (2, 20, 32, True)])
def test_rwkv_scan_bwd_matches_jax_vjp_of_the_oracle(N, S_, hd, state):
    """Every input's gradient, for the output's cotangent (the final
    state's zero, as in training), against jax.vjp of the reference's
    sequential oracle."""
    xs = _scan_inputs(N, S_, hd, seed=N + S_ + hd, state=state)
    out, vjp = jax.vjp(jax_ref.rwkv_scan, *map(jnp.asarray, xs[:6]))
    want = vjp((jnp.asarray(xs[6]), jnp.zeros_like(out[1])))
    got = ref.rwkv_scan_bwd(*(torch.from_numpy(x) for x in xs))
    for name, a, b in zip(NAMES, got, want):
        close(a, b, SCAN_RTOL, name)


def _jax_chunked(r, k, v, lw, u, s0, L):
    """rwkv_time_mix's jnp scan: the reference's _wkv_chunk over chunks of L."""
    state, outs = s0, []
    for c in range(0, r.shape[1], L):
        state, o = jax_blocks._wkv_chunk(state, r[:, c:c + L], k[:, c:c + L], v[:, c:c + L],
                                         lw[:, c:c + L], u)
        outs.append(o)
    return jnp.concatenate(outs, axis=1), state


@pytest.mark.parametrize("S_,L", [(32, 8), (64, 32)])
def test_rwkv_scan_bwd_matches_jax_vjp_of_the_chunked_scan(S_, L):
    """The same against jax.vjp of the chunked matrix form the reference's
    time mix differentiates (blocks._wkv_chunk), from a start state."""
    xs = _scan_inputs(2, S_, 16, seed=S_)
    out, vjp = jax.vjp(lambda *a: _jax_chunked(*a, L), *map(jnp.asarray, xs[:6]))
    want = vjp((jnp.asarray(xs[6]), jnp.zeros_like(out[1])))
    got = ref.rwkv_scan_bwd(*(torch.from_numpy(x) for x in xs))
    for name, a, b in zip(NAMES, got, want):
        close(a, b, SCAN_RTOL, name)


def _kernel_arithmetic(r, k, v, lw, u, s0, dout):
    """The backward kernel's two sweeps (csrc/rwkv_scan.cu), in f32 with the
    Phi walk in f64: sweep 1 runs the state forward and keeps R's factor
    S_{t-1} dout_t; sweep 2 runs G backward from 0, and per row
    dlw_t = Phi_t - k_t o (G_t v_t), Phi_{t-1} = dlw_t + r_t o (S_{t-1} dout_t),
    from Phi_{S-1} = 0: no state is needed in sweep 2."""
    N, S_, hd = r.shape
    e, u0 = torch.exp(lw), u[:, 0]
    st, drs = s0.clone(), torch.empty_like(r)
    for t in range(S_):
        drs[:, t] = torch.einsum("nkv,nv->nk", st, dout[:, t])
        st = e[:, t, :, None] * st + k[:, t, :, None] * v[:, t, None, :]
    G, phi = torch.zeros_like(s0), torch.zeros(N, hd, dtype=torch.float64)
    dr, dk, dv, dlw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u0)
    for t in range(S_ - 1, -1, -1):
        gv = torch.einsum("nkv,nv->nk", G, v[:, t])
        vd = (v[:, t] * dout[:, t]).sum(-1, keepdim=True)
        d = phi - (k[:, t] * gv).double()
        phi = d + (r[:, t] * drs[:, t]).double()
        dlw[:, t] = d.float()
        dk[:, t] = gv + u0 * r[:, t] * vd
        dr[:, t] = drs[:, t] + u0 * k[:, t] * vd
        dv[:, t] = torch.einsum("nkv,nk->nv", G, k[:, t]) \
            + (r[:, t] * u0 * k[:, t]).sum(-1, keepdim=True) * dout[:, t]
        du = du + r[:, t] * k[:, t] * vd
        G = r[:, t, :, None] * dout[:, t, None, :] + e[:, t, :, None] * G
    return dr, dk, dv, dlw, du[:, None], G


@pytest.mark.parametrize("strong,state", [(False, False), (True, True), (False, True)])
def test_rwkv_scan_bwd_kernel_arithmetic_matches_plain(strong, state):
    """At the served scale (r, k, v of std 8, a start state of std 100, decays
    down to -20 a step where ``strong``): the kernel's way to dlw, which never
    holds S_{t-1} and G_t at one step and never divides by e^{lw}, against
    the plain backward in f64."""
    xs = [torch.from_numpy(x) for x in _scan_inputs(4, 96, 64, seed=7, scale=8.0,
                                                     strong=strong, state=state)]
    got = _kernel_arithmetic(*xs)
    want = ref.rwkv_scan_bwd(*(x.double() for x in xs))
    for name, a, b in zip(NAMES, got, want):
        close(a, b, SCAN_RTOL, name)


def test_rwkv_scan_function_matches_autograd_and_serving_saves_nothing():
    """ops.rwkv_scan with a gradient goes through its autograd.Function (the
    plain backward on the CPU), equal within SCAN_RTOL to autograd through
    the plain forward; a loss that reaches the final state raises (training
    never differentiates it); without a gradient it is the forward alone: no
    graph, no launch counted on the CPU."""
    xs = [torch.from_numpy(x) for x in _scan_inputs(3, 17, 16, seed=3)]
    leaves = [x.clone().requires_grad_(True) for x in xs[:6]]
    out, st = ops.rwkv_scan(*leaves)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "_RwkvScanBackward"
    got = torch.autograd.grad((out * xs[6]).sum(), leaves)
    plain = [x.clone().requires_grad_(True) for x in xs[:6]]
    o2, _ = ref.rwkv_scan(*plain)
    want = torch.autograd.grad((o2 * xs[6]).sum(), plain)
    for name, a, b in zip(NAMES, got, want):
        close(a, b, SCAN_RTOL, name)
    out, st = ops.rwkv_scan(*leaves)
    with pytest.raises(ValueError, match="final state"):
        torch.autograd.grad((out * xs[6]).sum() + st.sum(), leaves)
    ops.reset_launches()
    with torch.no_grad():
        out, st = ops.rwkv_scan(*leaves)
    assert out.grad_fn is None and st.grad_fn is None
    assert ops.LAUNCHES["rwkv_scan"] == 0 and ops.LAUNCHES["rwkv_scan_bwd"] == 0


def _configs(dtype="float32"):
    """The same reduced rwkv6-7b in both packages, with non-zero W_up."""
    out = []
    for get in (jax_get_config, get_config):
        cfg = get("rwkv6-7b").reduced(dtype=dtype)
        out.append(dataclasses.replace(
            cfg, adapter=dataclasses.replace(cfg.adapter, zero_init_up=False)))
    return out


@functools.lru_cache(maxsize=None)
def jax_params(arch, seed=0):
    """JAX's f32 weights of the reduced ``arch``, the adapters perturbed from a
    numpy seed (W_up != 0); numpy leaves, which no test writes to."""
    cfg = jax_get_config(arch).reduced(dtype="float32")
    defs = jax_prm.param_defs(cfg)
    p = jax.tree.map(np.asarray, jax.jit(lambda key: jax_prm.materialize(defs, key, cfg.dtype))(
        jax.random.key(seed)))
    rng = np.random.default_rng(seed + 1)
    blocks_ = []
    for e in p["blocks"]:
        ad = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(v.dtype)
              for k, v in e["adapter"].items()}
        blocks_.append({**e, "adapter": ad})
    return {**p, "blocks": tuple(blocks_)}


def test_rwkv_time_mix_gradients_match_jax():
    """The time mix under autograd (the scan through its Function) against
    jax.vjp of the reference's (its chunked jnp scan), for the input and for
    weights of the projections, the decay LoRA and the bonus."""
    jcfg, tcfg = _configs()
    jp = jax_params("rwkv6-7b")
    tp = bridge.params_from_jax(jp, tcfg, device="cpu")
    jl = jax.tree.map(lambda a: a[0, 0], jp["blocks"][0]["rwkv"])     # layer 0
    tl = tp["blocks"][0]["rwkv"]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 20, tcfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, 20, tcfg.d_model)).astype(np.float32)
    names = ("wr", "wk", "wv", "dd_w1", "decay_base", "bonus_u")
    mix = lambda xx, *w: jax_blocks.rwkv_time_mix(jcfg, {**jl, **dict(zip(names, w))}, xx,
                                                  None)[0]
    want = jax.jit(lambda args, ct: jax.vjp(mix, *args)[1](ct))(
        [jnp.asarray(x)] + [jl[n] for n in names], jnp.asarray(dy))
    leaves = [torch.from_numpy(x).requires_grad_(True)] + \
        [tl[n].detach().clone().requires_grad_(True) for n in names]
    y, _ = blocks.rwkv_time_mix(tcfg, {**tl, **dict(zip(names, leaves[1:]))}, leaves[0], None)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    for name, a, b in zip(("x",) + names, got, want):
        close(a, np.asarray(b).reshape(a.shape), MIX_RTOL, name)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def walk_matches_jax(jcfg, tcfg, jp):
    """Three steps at depths 1, 1, 2 (interval 1): the boundary walks 1 -> 1 ->
    0, each step the port's make_train_step against the JAX package's on the
    same batch: the loss, the gradient norm, the head and every adapter after
    the step; the frozen layer's adapter and moments bit for bit while frozen,
    the hot ones moved. Returns the port's parameters after the walk."""
    jtc, tc = JaxTrainConfig(warmup_steps=2), TrainConfig(warmup_steps=2)
    tp = bridge.params_from_jax(jp, tcfg, device="cpu")
    jopt = jax_adamw.init(jax_training.full_trainable(jp))
    opt = adamw.init(training.full_trainable(tp, tcfg))
    sched = unfreeze.UnfreezeSchedule(depths=(1, 1, 2), interval=1)
    segs = unfreeze.boundary_schedule(tcfg, sched, 3)
    assert segs == [(0, 2, 1), (2, 3, 0)]
    slack = {}                     # leaf -> 2 lr for each step its gradient was near 0

    def add_slack(key, m_old, m_new, lr):
        g = (np.asarray(m_new) - jtc.beta1 * np.asarray(m_old)) / (1 - jtc.beta1)
        near0 = np.abs(g) <= RTOL_GRAD * np.abs(g).max()
        slack[key] = slack.get(key, 0.0) + np.where(near0, 2 * lr, 0.0)
    for start, end, boundary in segs:
        jstep = jax.jit(jax_training.make_train_step(jcfg, jtc, boundary))
        step = training.make_train_step(tcfg, tc, boundary)
        for s in range(start, end):
            batch = _batch(tcfg, seed=10 + s)
            before = [{k: t.clone() for k, t in b["adapter"].items()} for b in tp["blocks"]]
            m_before = [{k: t.clone() for k, t in a.items()} for a in opt["m"]["adapters"]]
            jm_old = jopt["m"]
            jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
            tp, opt, m = step(tp, opt, data_pipeline.to_device(batch, "cpu"))
            lr = float(jax_adamw.lr_at(jtc, jopt["count"]))
            close(m["loss"], jm["loss"], RTOL_FWD, f"step {s} loss")
            close(m["grad_norm"], jm["grad_norm"], RTOL_GRAD, f"step {s} grad norm")
            add_slack("head", jm_old["head"]["w"], jopt["m"]["head"]["w"], lr)
            close(tp["head"]["w"], jp["head"]["w"], RTOL_GRAD, f"step {s} head", slack["head"])
            for i, b in enumerate(tp["blocks"]):
                for leaf, t in b["adapter"].items():
                    if i >= boundary:
                        add_slack((i, leaf), jm_old["adapters"][0][leaf][i, 0],
                                  jopt["m"]["adapters"][0][leaf][i, 0], lr)
                    close(t, jp["blocks"][0]["adapter"][leaf][i, 0], RTOL_GRAD,
                          f"step {s} layer {i} {leaf}", slack.get((i, leaf)))
                    if i < boundary:
                        assert torch.equal(t, before[i][leaf])
                        assert torch.equal(opt["m"]["adapters"][i][leaf], m_before[i][leaf])
                    else:
                        assert not torch.equal(t, before[i][leaf])
            assert int(opt["count"]) == int(jopt["count"]) == s + 1
    return tp


def test_three_train_steps_with_walking_boundary_match_jax():
    """The LM step on reduced rwkv6-7b (the scans through their Function),
    the boundary walking 1 -> 1 -> 0, against the JAX package's step."""
    jcfg, tcfg = _configs()
    walk_matches_jax(jcfg, tcfg, jax_params("rwkv6-7b"))


def test_lowest_hot_block_runs_no_scan_backward():
    """At depth 1 the hot block's input is the frozen trunk's detached output
    and its time mix's weights are frozen: no input of its scan needs a
    gradient, so the scan runs as served (no Function, nothing saved) and
    only the adapter and the head are differentiated; at depth 2 the upper
    layer's gradient flows through the lower layer's scan."""
    _, tcfg = _configs()
    tp = bridge.params_from_jax(jax_params("rwkv6-7b"), tcfg, device="cpu")
    batch = data_pipeline.to_device(_batch(tcfg, seed=1), "cpu")
    seen = []
    real = ops._RwkvScan.apply

    def spy(*a):
        seen.append(True)
        return real(*a)
    ops._RwkvScan.apply = spy
    try:
        training.loss_and_grads(tp, batch, tcfg, 1)
        assert seen == []
        training.loss_and_grads(tp, batch, tcfg, 0)
        assert seen == [True]          # layer 0's scan: layer 1's gradient passes through it
    finally:
        ops._RwkvScan.apply = real


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_the_ring_refuses_recurrent_blocks(arch, capsys):
    """The reference's ring stops on rwkv and hymba blocks with a TypeError
    under shard_map, so the port's ring refuses them with a ValueError that
    names it: stage_stack, the ring backends' validation, the RingTrainer,
    the session and the CLI."""
    cfg = get_config(arch).reduced(dtype="float32")
    tc = TrainConfig(n_microbatches=1, batch_size=1, seq_len=8)
    match = "TypeError.*shard_map"
    from repro_torch.models import params as prm
    p = prm.materialize(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match=match):
        pipeline.stage_stack(p, cfg, 2)
    with pytest.raises(ValueError, match=match):
        backends._validate_ring(cfg, 2)
    with pytest.raises(ValueError, match=match):
        RingTrainer(cfg, tc, p, 2, 1)
    with pytest.raises(ValueError, match=match):
        RingSession.create(cfg, tc, backend="fused", n_stages=2, device="cpu")
    from repro_torch.launch import train
    with pytest.raises(ValueError, match=match):
        train.main(["--mode", "ring", "--arch", arch, "--reduced", "--stages", "2",
                    "--rounds", "1", "--device", "cpu"])


def test_train_cli_trains_rwkv_on_cpu(capsys):
    """--mode pjit --arch rwkv6-7b: one loss line per step, the boundary
    walking down."""
    from repro_torch.launch import train

    train.main(["--mode", "pjit", "--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                "--steps", "3", "--unfreeze-interval", "2", "--batch-size", "2",
                "--seq-len", "16"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert [ln.split()[:4] for ln in lines] == [["step", "0", "boundary", "1"],
                                                ["step", "1", "boundary", "1"],
                                                ["step", "2", "boundary", "0"]]
    assert all(np.isfinite(float(ln.split()[5])) for ln in lines)
