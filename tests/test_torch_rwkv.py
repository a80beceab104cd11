"""The port's RWKV-6 serving path against the JAX package, at reduced rwkv6-7b.

Reduced rwkv6-7b: d 256, 8 heads of 32, 2 layers, d_ff 512, vocab 512,
adapter bottleneck 16, every adapter with a non-zero ``W_up``. Weights are made
by the JAX package and carried across with ``repro_torch.bridge``. On the CPU
the port runs the plain versions of its kernels: ``ops.rwkv_scan`` is the
sequential oracle, ``impl="plain"`` the reference's chunked jnp form.

Tolerances, each with its reason:

- ``rwkv_scan``: the reference's own (tests/test_kernels.py), 1e-3 absolute
  and relative on unit-scale inputs; chaining 1e-4.
- f32 model: logits and block outputs 1e-4 absolute (fp32 sums in another
  order over two layers; the largest logit is about 3); the recurrent state,
  whose entries reach 1e3, 1e-5 of its largest entry.
- Served tokens: identical (greedy argmax of the f32 model).
- bf16 model: logits 5e-2 (bf16 rounding at different places in the two
  frameworks, as for the dense path); mix and block outputs 5e-2 plus two
  bf16 ulps of their largest entry (the channel mix's squared ReLU reaches
  20, where one ulp is 0.125, and the residual sums cancel such terms down
  to O(1) entries); ``px`` leaves two bf16
  ulps of their largest entry; the f32 state 2e-2 of its largest entry (r, k
  and v are rounded to bf16 before the scan, and one ulp of k or v moves a
  state entry by 2**-8 of its size).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api.tenants import AdapterStore as JaxAdapterStore  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import rwkv_scan as jax_rs  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import kvcache as jax_kvcache  # noqa: E402
from repro.models import params as jax_prm  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api.tenants import AdapterStore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv_scan as torch_rs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ATOL = {"float32": 1e-4, "bfloat16": 5e-2}            # logits, block outputs
OUT_RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -6}    # block outputs: plus this x max
STATE_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}      # of the state's largest entry
PX_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}    # of px's largest entry


def _configs(dtype: str):
    """The same reduced rwkv6-7b in both packages, with non-zero W_up."""
    out = []
    for get in (jax_get_config, get_config):
        cfg = get("rwkv6-7b").reduced(dtype=dtype)
        out.append(dataclasses.replace(
            cfg, adapter=dataclasses.replace(cfg.adapter, zero_init_up=False)))
    return out


def _models(dtype: str, seed: int = 0):
    jcfg, tcfg = _configs(dtype)
    jparams = jax_prm.materialize(jax_prm.param_defs(jcfg), jax.random.key(seed), jcfg.dtype)
    port = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, port


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close_out(got, want, dtype):
    """A mix or block output: ATOL plus OUT_RTOL of its largest entry."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL[dtype] + OUT_RTOL[dtype] * np.abs(want).max())


def _close_rel(got, want, rtol):
    """|got - want| <= rtol * max|want| (outputs whose scale is far from 1)."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def test_config_copy_matches_reference():
    for pick in (lambda g: g("rwkv6-7b"), lambda g: g("rwkv6-7b").reduced()):
        jc, tc = pick(jax_get_config), pick(get_config)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert jc.param_count() == tc.param_count()
    full = get_config("rwkv6-7b")
    assert (full.n_layers, full.d_model, full.ssm.head_dim, full.padded_vocab) == \
        (32, 4096, 64, 65536)
    assert full.param_count() == 7_626_821_632          # 15.25 GB in bf16
    small = get_config("rwkv6-7b").reduced()
    assert (small.d_model // small.ssm.head_dim, small.ssm.head_dim) == (8, 32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bridge_carries_every_leaf_exactly(dtype):
    jcfg, tcfg, jparams, port = _models(dtype)
    shapes = prm.materialize(tcfg, seed=0, device="cpu")
    assert len(port["blocks"]) == tcfg.n_layers == 2
    for layer in range(tcfg.n_layers):
        for sub in ("ln1", "ln2", "rwkv", "adapter"):
            assert set(port["blocks"][layer][sub]) == set(jparams["blocks"][0][sub])
            for leaf, t in port["blocks"][layer][sub].items():
                want = np.asarray(jparams["blocks"][0][sub][leaf][layer, 0], np.float32)
                np.testing.assert_array_equal(_np(t), want)
                assert t.dtype == shapes["blocks"][layer][sub][leaf].dtype
                assert t.shape == shapes["blocks"][layer][sub][leaf].shape
    for name in ("tok", "pos"):
        np.testing.assert_array_equal(_np(port["embed"][name]),
                                      np.asarray(jparams["embed"][name], np.float32))
        assert port["embed"][name].shape == shapes["embed"][name].shape
    assert shapes["embed"]["pos"].shape == (4096, 256)


@pytest.mark.parametrize("dtype,full", [("bfloat16", False), ("bfloat16", True),
                                        ("float32", True), ("float32", False)])
def test_materialize_decay_base_equals_jax(dtype, full):
    """The decay prior is one ramp over the whole stacked leaf, so each layer
    gets its own slice of it; no random numbers, so the test is exact. One
    exception, in f32 at the reduced size only: XLA's CPU code computes the
    last (n - 1) mod 32 entries of the stacked leaf in its loop's scalar
    epilogue, without the fused multiply-add its vectorised body uses for
    1 - i / (n - 1), which moves some of them by up to 3 f32 ulps; at full
    width those entries agree too."""
    pick = (lambda g: g("rwkv6-7b")) if full else (lambda g: g("rwkv6-7b").reduced())
    jcfg = dataclasses.replace(pick(jax_get_config), dtype=dtype)
    tcfg = dataclasses.replace(pick(get_config), dtype=dtype)
    pd = jax_prm.param_defs(jcfg)["blocks"][0]["rwkv"]["decay_base"]
    want = np.asarray(jax_prm._init_leaf(pd, jax.random.key(0), jnp.dtype(dtype))
                      .astype(jnp.float32))
    if full:      # only the decay leaves: the whole model is 7.6 B parameters
        got = [prm._init_leaf(b["rwkv"]["decay_base"], prm.DTYPES[dtype], None,
                              torch.device("cpu")) for b in prm.param_defs(tcfg)["blocks"]]
    else:
        got = [b["rwkv"]["decay_base"] for b in prm.materialize(tcfg, seed=0,
                                                               device="cpu")["blocks"]]
    assert len(got) == tcfg.n_layers and all(g.dtype == prm.DTYPES[dtype] for g in got)
    got = np.stack([_np(g) for g in got]).ravel()
    want = want.ravel()
    epilogue = np.arange(want.size) >= want.size - 1 - (want.size - 1) % 32
    exact = ~epilogue if (dtype == "float32" and not full) else np.ones_like(epilogue)
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_array_max_ulp(got, want, maxulp=3)
    assert got.min() == -6.0 and got.max() == -0.5


def _scan_inputs(N, S, hd, seed, state=True):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((N, S, hd), np.float32) for _ in range(3))
    lw = -np.exp(0.5 * rng.standard_normal((N, S, hd), np.float32) - 1.0)
    u = 0.5 * rng.standard_normal((N, 1, hd), np.float32)
    s0 = (0.1 * rng.standard_normal((N, hd, hd), np.float32) if state
          else np.zeros((N, hd, hd), np.float32))
    return r, k, v, lw.astype(np.float32), u, s0


@pytest.mark.parametrize("N,S,hd,chunk", [(2, 32, 16, 8), (4, 64, 32, 32),
                                          (1, 96, 64, 32), (3, 40, 8, 16)])
def test_rwkv_scan_matches_reference_and_pallas(N, S, hd, chunk):
    """The reference's sweep: the port's plain version against the reference's
    oracle and the Pallas kernel in interpret mode."""
    xs = _scan_inputs(N, S, hd, seed=N * S + hd)
    got, got_s = ops.rwkv_scan(*map(torch.from_numpy, xs))
    want, want_s = jax_ref.rwkv_scan(*map(jnp.asarray, xs))
    pallas, pallas_s = jax_rs.rwkv_scan(*map(jnp.asarray, xs), chunk=chunk, interpret=True)
    for a, b in ((got, want), (got_s, want_s), (got, pallas), (got_s, pallas_s)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-3, rtol=1e-3)


def test_rwkv_scan_state_chaining():
    """Two halves with the state carried equal one pass, and a non-zero state0
    carries through (against the reference's oracle)."""
    r, k, v, lw, u, s0 = map(torch.from_numpy, _scan_inputs(2, 64, 16, seed=1))
    zero = torch.zeros_like(s0)
    full, sT = ops.rwkv_scan(r, k, v, lw, u, zero)
    h1, s1 = ops.rwkv_scan(r[:, :32], k[:, :32], v[:, :32], lw[:, :32], u, zero)
    h2, s2 = ops.rwkv_scan(r[:, 32:], k[:, 32:], v[:, 32:], lw[:, 32:], u, s1)
    np.testing.assert_allclose(_np(torch.cat([h1, h2], 1)), _np(full), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(s2), _np(sT), atol=1e-4, rtol=1e-4)
    got, got_s = ops.rwkv_scan(r, k, v, lw, u, s0)
    want, want_s = jax_ref.rwkv_scan(*(jnp.asarray(t.numpy()) for t in (r, k, v, lw, u, s0)))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(_np(got_s), _np(want_s), atol=1e-3, rtol=1e-3)
    assert not np.allclose(_np(got), _np(full))           # state0 mattered


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Cut fp32 to TF32 (10 mantissa bits), as the kernel cuts each hi part and
    as the tensor core reads the fp32 bits it is given for a TF32 operand."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, products: str) -> torch.Tensor:
    """a @ b in "fp32", as "3xtf32" (a_lo b_hi + a_hi b_lo + a_hi b_hi, with
    x = x_hi + x_lo exactly) or as one "tf32" product."""
    if products == "fp32":
        return a @ b
    ahi, bhi = _tf32(a), _tf32(b)
    if products == "tf32":
        return ahi @ bhi
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def _chunked_scan(r, k, v, lw, u, s0, products: str, L: int = 16):
    """The CUDA kernel's decomposition in plain torch: chunks of L steps (the
    last one padded with r = k = v = lw = 0), every decay a running product of
    e^{lw} (every factor <= 1): forward, r o e^{ca_prev} and e^{ca_L};
    backward, k o e^{ca_L - ca}; and along t for the pairwise decays of A's
    two diagonal 8 x 8 blocks. A's off-diagonal block is factorised at the
    second sub-chunk's first step b: r_t e^{ca_prev[t] - ca_prev[b]} and
    k_s e^{ca_prev[b] - ca[s]}, both <= 1. The bonus sits on A's diagonal,
    and the four products (A's off-diagonal block, inter, A V, hand-off) run
    in fp32, as 3xTF32 (the kernel's) or as one TF32 product each."""
    N, S, hd = r.shape
    pad = -S % L
    r, k, v, lw = (torch.cat([x, x.new_zeros(N, pad, hd)], 1) for x in (r, k, v, lw))
    w = torch.exp(lw)
    state, outs = s0, []
    for c0 in range(0, S + pad, L):
        rc, kc, vc, wc = (x[:, c0:c0 + L] for x in (r, k, v, w))
        ones = torch.ones_like(wc[:, :1])
        fwd = torch.cumprod(torch.cat([ones, wc[:, :-1]], 1), 1)          # e^{ca_prev}
        bwd = torch.flip(torch.cumprod(torch.cat([ones, torch.flip(wc, [1])[:, :-1]], 1), 1),
                         [1])                                               # e^{ca_L - ca}
        rd, kd = rc * fwd, kc * bwd
        decay = fwd[:, -1] * wc[:, -1]                                      # e^{ca_L}
        A = torch.zeros(N, L, L)
        H = L // 2
        for s in range(L):                                      # the two diagonal blocks
            A[:, s, s] = (rc[:, s] * u[:, 0] * kc[:, s]).sum(-1)
            run = kc[:, s]                                      # k_s e^{ca_prev[t] - ca[s]}
            for t in range(s + 1, (s // H + 1) * H):
                A[:, t, s] = (rc[:, t] * run).sum(-1)
                run = run * wc[:, t]
        # the off-diagonal block, factorised at step H: both factors <= 1
        rq = rc[:, H:] * torch.cumprod(torch.cat([ones, wc[:, H:-1]], 1), 1)
        kq = kc[:, :H] * torch.flip(torch.cumprod(
            torch.cat([ones, torch.flip(wc[:, 1:H], [1])], 1), 1), [1])
        A[:, H:, :H] = _mm(rq, kq.transpose(1, 2), products)
        outs.append(_mm(rd, state, products) + _mm(A, vc, products))
        state = decay[:, :, None] * state + _mm(kd.transpose(1, 2), vc, products)
    return torch.cat(outs, 1)[:, :S], state


def _served_scale_inputs(N, S, hd, scale, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (scale * rng.standard_normal((N, S, hd)).astype(np.float32) for _ in range(3))
    lw = -np.exp(rng.uniform(-6.0, 3.0, (N, S, hd))).astype(np.float32)
    u = 0.5 * rng.standard_normal((N, 1, hd)).astype(np.float32)
    s0 = (12.5 * scale * rng.standard_normal((N, hd, hd))).astype(np.float32)
    return r, k, v, lw, u, s0


@pytest.mark.parametrize("products", ["fp32", "3xtf32"])
@pytest.mark.parametrize("N,S,hd,scale", [(2, 1, 8, 1.0), (3, 7, 16, 1.0), (2, 33, 32, 1.0),
                                          (2, 50, 64, 1.0), (2, 100, 64, 8.0)])
def test_rwkv_scan_kernel_decomposition_matches_reference(N, S, hd, scale, products):
    """The kernel's chunked form against the reference's oracle, at decays
    down to -e^3 = -20 a step (where a factorisation through e^{-ca} would
    overflow), ragged S and every head dim. Unit-scale inputs at the
    reference's 1e-3; the served scale (r, k, v of std 8, state of std 100)
    at 1e-4 of the largest entry, the tolerance the kernel is held to on the
    card."""
    xs = _served_scale_inputs(N, S, hd, scale, seed=S * hd)
    got, got_s = _chunked_scan(*map(torch.from_numpy, xs), products=products)
    want, want_s = jax_ref.rwkv_scan(*map(jnp.asarray, xs))
    assert np.isfinite(_np(got)).all() and np.isfinite(_np(got_s)).all()
    for a, b in ((got, want), (got_s, want_s)):
        if scale == 1.0:
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-3, rtol=1e-3)
        else:
            _close_rel(a, b, 1e-4)


def test_rwkv_scan_one_tf32_product_misses_the_tolerance():
    """Why the kernel splits its operands: with one TF32 product each (about
    three digits), the served scale's outputs and state miss 1e-4 of their
    largest entry."""
    xs = _served_scale_inputs(2, 100, 64, 8.0, seed=6400)
    got, got_s = _chunked_scan(*map(torch.from_numpy, xs), products="tf32")
    want, want_s = jax_ref.rwkv_scan(*map(jnp.asarray, xs))
    for a, b in ((got, want), (got_s, want_s)):
        assert np.abs(_np(a) - _np(b)).max() > 1e-4 * np.abs(_np(b)).max()


def test_rwkv_scan_launcher_takes_cuda_tensors_only():
    """No silent fallback, and the head dims and dtype the kernel takes."""
    xs = [torch.from_numpy(x) for x in _scan_inputs(2, 8, 16, seed=2)]
    with pytest.raises(ValueError, match="CUDA"):
        torch_rs.rwkv_scan(*xs)
    torch_rs.check(*xs)
    bad = [torch.from_numpy(x) for x in _scan_inputs(2, 8, 48, seed=2)]
    with pytest.raises(ValueError, match="head_dim"):
        torch_rs.check(*bad)
    with pytest.raises(ValueError, match="float32"):
        torch_rs.check(xs[0].double(), *xs[1:])
    with pytest.raises(ValueError, match="S >= 1"):
        torch_rs.check(*(x[:, :0] if x.shape[1] == 8 else x for x in xs))
    ops.reset_launches()
    ops.rwkv_scan(*xs)
    assert ops.LAUNCHES["rwkv_scan"] == 0                 # a CPU tensor is no launch


def _cache_pair(jcfg, tcfg, B, rng):
    """One layer's rwkv cache with random state and px, in both packages."""
    jc = jax.tree.map(lambda x: x[0, 0], jax_kvcache.init_cache(jcfg, B, 8)["layers"][0])
    vals = {name: (rng.standard_normal(x.shape) * (30.0 if name == "state" else 1.0))
            .astype(np.float32) for name, x in jc.items()}
    jc = {name: jnp.asarray(vals[name]).astype(x.dtype) for name, x in jc.items()}
    tc = kvcache.init_cache(tcfg, B, 8, dtype=torch.bfloat16)["layers"][0]
    tc = {name: bridge.to_tensor(np.asarray(jc[name]), "cpu") for name in tc}
    return jc, tc


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("mode", ["seq", "step"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rwkv_mixes_and_block_match_jax(dtype, mode, impl):
    """rwkv_time_mix, rwkv_channel_mix and apply_block("rwkv") on the same
    input: a 37-token sequence from an empty state ("seq"; chunk 1 in the
    plain form) or one token against a random cache ("step")."""
    jcfg, tcfg, jparams, port = _models(dtype, seed=3)
    jp = jax.tree.map(lambda x: x[1, 0], jparams["blocks"][0])
    tp = port["blocks"][1]
    rng = np.random.default_rng(4)
    B, S = 2, (37 if mode == "seq" else 1)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jcfg.dtype), torch.from_numpy(x).to(prm.DTYPES[dtype])
    jimpl = {"kernel": "pallas", "plain": "jnp"}[impl]
    if mode == "seq":
        jc, tc = None, None
    else:
        jc, tc = _cache_pair(jcfg, tcfg, B, rng)

    jy, jnc = jax_blocks.rwkv_time_mix(jcfg, jp["rwkv"], xj, jc, impl=jimpl)
    ty, tnc = blocks.rwkv_time_mix(tcfg, tp["rwkv"], xt, tc, impl=impl)
    assert ty.dtype == xt.dtype and ty.shape == xt.shape
    _close_out(ty, jy, dtype)
    jy, jnc2 = jax_blocks.rwkv_channel_mix(jcfg, jp["rwkv"], xj, jnc)
    ty, tnc2 = blocks.rwkv_channel_mix(tcfg, tp["rwkv"], xt, tnc)
    _close_out(ty, jy, dtype)
    if mode == "step":
        _close_rel(tnc2["state"], jnc2["state"], STATE_RTOL[dtype])
        for name in ("px_tm", "px_cm"):
            assert tnc2[name].dtype == xt.dtype
            np.testing.assert_array_equal(_np(tnc2[name]), _np(xt[:, -1]))

    pos = np.broadcast_to(np.arange(S), (B, S))
    jctx = jax_blocks.BlockCtx(cfg=jcfg, mode=mode, positions=jnp.asarray(pos), impl=jimpl)
    tctx = blocks.BlockCtx(cfg=tcfg, mode=mode, positions=torch.from_numpy(pos.copy()),
                           impl=impl)
    jh, jbc, _ = jax_blocks.apply_block("rwkv", jcfg, jp, xj, jctx, jc)
    th, tbc, _ = blocks.apply_block("rwkv", tcfg, tp, xt, tctx, tc)
    _close_out(th, jh, dtype)
    if mode == "step":
        _close_rel(tbc["state"], jbc["state"], STATE_RTOL[dtype])
        for name in ("px_tm", "px_cm"):
            _close_rel(tbc[name], jbc[name], PX_RTOL[dtype])


def test_kernel_and_plain_forms_agree_on_ragged_lengths():
    """The scan (sequential) and the chunked form over the reference's chunk
    choice, at a prompt length whose chunk falls to 5 (445 = 5 * 89)."""
    _, tcfg, _, port = _models("float32", seed=5)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 512, (1, 445)))
    assert blocks._chunk_of(445, 32) == 5
    a, _ = tfm.forward(port, toks, tcfg)
    b, _ = tfm.forward(port, toks, tcfg, impl="plain")
    torch.testing.assert_close(a, b, rtol=0, atol=ATOL["float32"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prefill_and_decode_match_reference(dtype):
    """prefill (the Pallas scan in the reference, the plain scan here) and six
    decode steps; logits and every cache leaf."""
    jcfg, tcfg, jparams, port = _models(dtype)
    B, S, seq_len = 2, 45, 60
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    atol = ATOL[dtype]

    jl, jc = jax_tfm.prefill(jparams, jnp.asarray(toks), jcfg, seq_len=seq_len, impl="pallas")
    tl, tc = tfm.prefill(port, torch.from_numpy(toks).long(), tcfg, seq_len=seq_len)
    assert tl.dtype == getattr(torch, dtype) and tl.shape == (B, tcfg.padded_vocab)

    def check_cache():
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        np.testing.assert_array_equal(tc["next"].numpy(), np.asarray(jc["next"]))
        for i in range(tcfg.n_layers):
            layer = tc["layers"][i]
            assert set(layer) == {"state", "px_tm", "px_cm"}
            assert layer["state"].dtype == torch.float32
            for name in ("px_tm", "px_cm"):       # the normed input's dtype
                assert layer[name].dtype == getattr(torch, dtype)
                _close_rel(layer[name], jc["layers"][0][name][i, 0], PX_RTOL[dtype])
            _close_rel(layer["state"], jc["layers"][0]["state"][i, 0], STATE_RTOL[dtype])

    np.testing.assert_allclose(_np(tl), _np(jl), atol=atol)
    check_cache()
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    for _ in range(6):
        jl, jc = jax_tfm.decode_step(jparams, jtok, jc, jcfg, impl="pallas")
        tl, tc = tfm.decode_step(port, torch.tensor(np.asarray(jtok)).long(), tc, tcfg)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=atol)
        check_cache()
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]


def test_decode_embeds_learned_positions_from_the_cache():
    """Decode adds the position table at ``cache["next"]``: one step after a
    prefill equals the last logits of a prefill one token longer."""
    _, tcfg, _, port = _models("float32", seed=6)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 512, (2, 20)))
    _, cache = tfm.prefill(port, toks[:, :-1], tcfg, seq_len=24)
    step, _ = tfm.decode_step(port, toks[:, -1:], cache, tcfg)
    full, _ = tfm.prefill(port, toks, tcfg, seq_len=24)
    torch.testing.assert_close(step, full, rtol=0, atol=ATOL["float32"])
    assert kvcache.layer_kinds(tcfg) == ["rwkv", "rwkv"]


def _requests(cls, vocab, tenants=(None,)):
    rng = np.random.default_rng(9)
    return [cls(i, rng.integers(0, vocab, size=int(rng.integers(5, 30))).astype(np.int32), 5,
                tenant=tenants[i % len(tenants)])
            for i in range(4)]


def test_batch_server_and_registry_match_reference(tmp_path):
    """Identical greedy tokens from both servers (f32 config), for the trunk
    and for a tenant whose adapter+head bundle the JAX AdapterStore wrote."""
    jcfg, tcfg, jparams, port = _models("float32")
    rng = np.random.default_rng(11)
    rnd = lambda x: jnp.asarray(0.05 * rng.standard_normal(x.shape, np.float32)).astype(x.dtype)
    bundle = {"adapter": jax.tree.map(rnd, jparams["blocks"][0]["adapter"]),
              "head": jax.tree.map(rnd, jparams["head"])}
    JaxAdapterStore(str(tmp_path)).put("t1", bundle, step=1)
    jreg = jax_serve.AdapterRegistry(jparams, JaxAdapterStore(str(tmp_path)))
    treg = serve.AdapterRegistry(port, AdapterStore(str(tmp_path)))
    assert treg.refresh() == ["t1"]
    grafted = treg.params_for("t1")["blocks"]
    for layer in range(tcfg.n_layers):
        np.testing.assert_array_equal(_np(grafted[layer]["adapter"]["w_down"]),
                                      np.asarray(bundle["adapter"]["w_down"][layer, 0]))
        assert grafted[layer]["rwkv"] is port["blocks"][layer]["rwkv"]   # shared trunk

    tenants = (None, "t1")
    jsrv = jax_serve.BatchServer(jcfg, jparams, slots=2, horizon=40, impl="pallas",
                                 registry=jreg)
    tsrv = serve.BatchServer(tcfg, port, slots=2, horizon=40, registry=treg, device="cpu")
    want = jsrv.run(_requests(jax_serve.Request, jcfg.vocab_size, tenants), log=lambda *a: None)
    got = tsrv.run(_requests(serve.Request, tcfg.vocab_size, tenants), log=lambda *a: None)
    assert got == want
    assert [b["rows"] for b in tsrv.batches] == [2, 2]


def test_cli_serves_rwkv_on_cpu(capsys):
    serve.main(["--arch", "rwkv6-7b", "--device", "cpu", "--requests", "3", "--slots", "2",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "on cpu" in out
