"""Training hymba-1.5b in the port against the JAX package, on the CPU.

The pieces first: the plain backward of the selective scan
(``ref.mamba_scan_bwd``, the yardstick of the backward kernel on the card)
against ``jax.vjp`` of the reference's sequential oracle
(``repro.kernels.ref.mamba_scan``; a start state enters it as
e^{log_a_0} state0 added to b_0), every input's gradient included
(``dstate0``); the plain attention backward with sinks
(``ref.flash_attention_bwd(n_sink=...)``) against ``jax.vjp`` of the
reference's ``blocks._attend`` with ``n_sink``, at windows shorter than the
keys, so that the sinks change the mask; the ``autograd.Function``s of
``ops.mamba_scan`` and of ``ops.flash_attention`` with sinks against autograd
through the plain forwards. Then the Mamba mix's gradients against
``jax.vjp`` of the reference's ``mamba_mix`` (its chunked associative scan),
with and without a start state, and the port's LM step on a reduced
hymba-1.5b (2 layers, d 256, 4 query heads over 2 of 64, window 128, 128 meta
tokens that stay frozen, SSM state 8, adapter m 16, f32, weights made by
JAX and carried by the bridge, W_up != 0) against the JAX package's
``make_train_step`` over 3 steps with a walking boundary
(``test_torch_rwkv_train.walk_matches_jax``). The ring's refusal of hymba
is held in tests/test_torch_rwkv_train.py beside rwkv's.

Tolerances, each with its reason:

- The plain backwards against ``jax.vjp``: 1e-5 of each gradient's largest
  entry (f32 sums in another order).
- The ``autograd.Function``s against autograd through the plain forward:
  1e-5 of each gradient's largest entry.
- The Mamba mix's input and weight gradients: 1e-4 of each gradient's
  largest entry (f32 through the conv, the softplus and three projections,
  summed in another order in each framework).
- The 3-step walk: the tolerances of
  ``tests/test_torch_train.py::test_three_train_steps_with_walking_boundary_match_jax``
  (the loss 1e-5 relative, the gradient norm and the parameters 5e-4 of the
  leaf's largest entry, 2 lr a step of slack where a gradient lies within
  that gap of 0, the frozen layer bit for bit).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import training  # noqa: E402
from repro_torch.data import pipeline as data_pipeline  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from test_torch_rwkv_train import close, jax_params, walk_matches_jax  # noqa: E402

SCAN_RTOL = 1e-5       # plain backwards vs jax.vjp; the Functions vs autograd
MIX_RTOL = 1e-4        # the Mamba mix's gradients, of each gradient's largest entry


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tests run many small ops (the
    plain scans step by step), which a thread per core slows many times over
    when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(B, S, D, N, seed):
    """log_a = dt A (dt = softplus(x), A = -(1..N)), b, c, a start state and
    dy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    dt = np.log1p(np.exp(f(B, S, D)))[..., None]
    log_a = (dt * -np.arange(1, N + 1, dtype=np.float32)).astype(np.float32)
    return log_a, (dt * f(B, S, D, N)).astype(np.float32), f(B, S, N), 3 * f(B, D, N), \
        f(B, S, D)


def _jax_scan_from(log_a, b, c, s0):
    """The reference's oracle from a start state: the first step's e^{log_a_0}
    s0 joins its b_0."""
    b = b.at[:, 0].add(jnp.exp(log_a[:, 0]) * s0)
    return jax_ref.mamba_scan(log_a, b, c)


@pytest.mark.parametrize("B,S,D,N,state", [(2, 9, 5, 4, True), (1, 37, 16, 8, False),
                                           (2, 20, 3, 16, True)])
def test_mamba_scan_bwd_matches_jax_vjp_of_the_oracle(B, S, D, N, state):
    """Every input's gradient, for y's cotangent (the final state's zero, as
    in training), against jax.vjp of the reference's oracle."""
    la, b, c, s0, dy = _scan_inputs(B, S, D, N, seed=B + S + D + N)
    args = [jnp.asarray(x) for x in (la, b, c, s0)]
    if state:
        out, vjp = jax.vjp(_jax_scan_from, *args)
    else:
        out, vjp = jax.vjp(jax_ref.mamba_scan, *args[:3])
    want = vjp((jnp.asarray(dy), jnp.zeros_like(out[1])))
    t = [torch.from_numpy(x) for x in (la, b, c, s0, dy)]
    got = ref.mamba_scan_bwd(t[0], t[1], t[2], t[3] if state else None, t[4])
    for name, a, w in zip(("dlog_a", "db", "dc", "dstate0"), got, want):
        close(a, w, SCAN_RTOL, name)


# (Sq, Sk, window, n_sink): the window shorter than the keys, sinks ending
# inside a 64-key tile, Sk > Sq, and a window the meta tokens fill
SINK_CASES = [(40, 40, 8, 5), (37, 100, 16, 70), (70, 70, 20, 64), (30, 152, 128, 128)]


@pytest.mark.parametrize("Sq,Sk,window,n_sink", SINK_CASES)
def test_attention_bwd_with_sinks_matches_jax_vjp_of_attend(Sq, Sk, window, n_sink):
    """dq, dk, dv of attention with sinks (hymba's GQA of 2 query heads over
    1 KV head here), from the forward's own output and row logsumexp,
    against jax.vjp of the reference's _attend with n_sink."""
    rng = np.random.default_rng(Sq + Sk)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v, do = f(2, Sq, 4, 64), f(2, Sk, 2, 64), f(2, Sk, 2, 64), f(2, Sq, 4, 64)
    pos_k = np.broadcast_to(np.arange(Sk), (2, Sk))
    pos_q = pos_k[:, Sk - Sq:]
    attend = lambda a, b_, c: jax_blocks._attend(
        a, b_, c, jnp.asarray(pos_q), jnp.asarray(pos_k), causal=True, window=window,
        n_sink=n_sink, q_chunk=Sq)
    want = jax.jit(lambda args, ct: jax.vjp(attend, *args)[1](ct))(
        list(map(jnp.asarray, (q, k, v))), jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = ref.flash_attention(tq, tk, tv, window=window, n_sink=n_sink, lse=True)
    got = ref.flash_attention_bwd(tq, tk, tv, out, lse, tdo, window=window, n_sink=n_sink)
    without = ref.flash_attention_bwd(tq, tk, tv, out, lse, tdo, window=window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        close(a, w, SCAN_RTOL, name)
    assert any((a - b).abs().max() > 1e-3 for a, b in zip(got, without))   # sinks matter


def test_scan_and_sink_functions_match_autograd_and_serving_saves_nothing():
    """ops.mamba_scan (from a start state and from none) and ops.flash_attention
    with sinks, with a gradient, go through their autograd.Functions (the
    plain backwards on the CPU), within SCAN_RTOL of autograd through the
    plain forwards; a loss that reaches the scan's final state raises
    (training never differentiates it); without a gradient they are the
    forward alone."""
    la, b, c, s0, dy = map(torch.from_numpy, _scan_inputs(2, 13, 6, 4, seed=5))
    for start in (s0, None):
        leaves = [x.clone().requires_grad_(True) for x in (la, b, c)] + \
            ([] if start is None else [start.clone().requires_grad_(True)])
        y, st = ops.mamba_scan(*leaves[:3], leaves[3] if start is not None else None)
        assert type(y.grad_fn).__name__ == "_MambaScanBackward"
        got = torch.autograd.grad((y * dy).sum(), leaves)
        plain = [x.clone().requires_grad_(True) for x in leaves]
        y2, _ = ref.mamba_scan(*plain[:3], plain[3] if start is not None else None)
        want = torch.autograd.grad((y2 * dy).sum(), plain)
        for a, w in zip(got, want):
            close(a, w, SCAN_RTOL)
        y, st = ops.mamba_scan(*leaves[:3], leaves[3] if start is not None else None)
        with pytest.raises(ValueError, match="final state"):
            torch.autograd.grad((y * dy).sum() + st.sum(), leaves)
    rng = np.random.default_rng(6)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((1, 70, 4, 64), (1, 70, 2, 64), (1, 70, 2, 64), (1, 70, 4, 64)))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, window=20, n_sink=40)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, do)
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention(*plain, window=20, n_sink=40), plain, do)
    for a, w in zip(got, want):
        close(a, w, SCAN_RTOL)
    ops.reset_launches()
    with torch.no_grad():
        y, st = ops.mamba_scan(la.requires_grad_(True), b, c)
        out = ops.flash_attention(*leaves, window=20, n_sink=40)
    assert y.grad_fn is None and out.grad_fn is None
    assert all(n == 0 for n in ops.LAUNCHES.values())


def _configs(dtype="float32"):
    """The same reduced hymba-1.5b in both packages, with non-zero W_up."""
    out = []
    for get in (jax_get_config, get_config):
        cfg = get("hymba-1.5b").reduced(dtype=dtype)
        out.append(dataclasses.replace(
            cfg, adapter=dataclasses.replace(cfg.adapter, zero_init_up=False)))
    return out


@pytest.mark.parametrize("start", [False, True])
def test_mamba_mix_gradients_match_jax(start):
    """The Mamba mix under autograd (the scan through its Function) against
    jax.vjp of the reference's, for the input, the projections, a_log and,
    with ``start``, a cache's ssm state (the scan's start state) and conv
    tail."""
    jcfg, tcfg = _configs()
    jp = jax_params("hymba-1.5b")
    tp = bridge.params_from_jax(jp, tcfg, device="cpu")
    jl = jax.tree.map(lambda a: a[1, 0], jp["blocks"][0]["ssm"])      # layer 1
    tl = tp["blocks"][1]["ssm"]
    rng = np.random.default_rng(12)
    B, S = 2, 20
    di, N, W = tcfg.n_heads * tcfg.head_dim, tcfg.ssm.state_size, tcfg.ssm.conv_width
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((B, S, di)).astype(np.float32)
    ssm = 3 * rng.standard_normal((B, di, N)).astype(np.float32)
    conv = rng.standard_normal((B, W - 1, di)).astype(np.float32)
    names = ("in_proj", "x_proj", "dt_proj", "a_log")

    def jfun(xx, *w):
        p = {**jl, **dict(zip(names, w[:4]))}
        cache = {"ssm": w[4], "conv": jnp.asarray(conv)} if start else None
        return jax_blocks.mamba_mix(jcfg, p, xx, cache)[0]
    jargs = [jnp.asarray(x)] + [jl[n] for n in names] + ([jnp.asarray(ssm)] if start else [])
    want = jax.jit(lambda args, ct: jax.vjp(jfun, *args)[1](ct))(jargs, jnp.asarray(dy))
    leaves = [torch.from_numpy(x).requires_grad_(True)] + \
        [tl[n].detach().clone().requires_grad_(True) for n in names] + \
        ([torch.from_numpy(ssm).requires_grad_(True)] if start else [])
    cache = {"ssm": leaves[5], "conv": torch.from_numpy(conv)} if start else None
    y, _ = blocks.mamba_mix(tcfg, {**tl, **dict(zip(names, leaves[1:5]))}, leaves[0], cache)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    for name, a, b in zip(("x",) + names + ("ssm",), got, want):
        close(a, np.asarray(b).reshape(a.shape), MIX_RTOL, name)


def test_three_train_steps_with_walking_boundary_match_jax():
    """The LM step on reduced hymba-1.5b (the scans, attention with its 128
    sinks and the adapters through their Functions; the meta tokens frozen),
    the boundary walking 1 -> 1 -> 0, against the JAX package's step."""
    jcfg, tcfg = _configs()
    jp = jax_params("hymba-1.5b")
    tp = walk_matches_jax(jcfg, tcfg, jp)
    assert torch.equal(tp["meta"], bridge.params_from_jax(jp, tcfg, device="cpu")["meta"])


def test_lowest_hot_block_runs_no_scan_or_attention_backward():
    """At depth 1 the hot block's input is the frozen trunk's detached output
    and its mixes' weights are frozen: neither its scan nor its attention
    goes through a Function (nothing saved); only the adapter and the head
    are differentiated. At depth 2 layer 1's gradient flows through layer
    0's scan and attention."""
    _, tcfg = _configs()
    tp = bridge.params_from_jax(jax_params("hymba-1.5b"), tcfg, device="cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    batch = data_pipeline.to_device({"tokens": tokens, "labels": tokens}, "cpu")
    seen = []
    real = ops._MambaScan.apply, ops._FlashAttention.apply

    def spy(name, fn):
        def call(*a):
            seen.append(name)
            return fn(*a)
        return call
    ops._MambaScan.apply, ops._FlashAttention.apply = spy("scan", real[0]), spy("attn", real[1])
    try:
        training.loss_and_grads(tp, batch, tcfg, 1)
        assert seen == []
        training.loss_and_grads(tp, batch, tcfg, 0)
        assert sorted(seen) == ["attn", "scan"]
    finally:
        ops._MambaScan.apply, ops._FlashAttention.apply = real


def test_train_cli_trains_hymba_on_cpu(capsys):
    """--mode pjit --arch hymba-1.5b: one loss line per step, the boundary
    walking down."""
    from repro_torch.launch import train

    train.main(["--mode", "pjit", "--arch", "hymba-1.5b", "--reduced", "--device", "cpu",
                "--steps", "3", "--unfreeze-interval", "2", "--batch-size", "2",
                "--seq-len", "16"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert [ln.split()[:4] for ln in lines] == [["step", "0", "boundary", "1"],
                                                ["step", "1", "boundary", "1"],
                                                ["step", "2", "boundary", "0"]]
    assert all(np.isfinite(float(ln.split()[5])) for ln in lines)
