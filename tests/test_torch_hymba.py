"""The port's Hymba serving path against the JAX package, at reduced hymba-1.5b.

Reduced hymba-1.5b: d 256, 4 query heads over 2 KV heads (head_dim 64), a
sliding window of 128 and 128 meta tokens (the attention sinks), SSM state 8,
dt_rank 16, conv width 4, d_ff 512, vocab 512, 2 layers, adapter bottleneck 16,
every adapter with a non-zero ``W_up``. Weights are made by the JAX package and
carried across with ``repro_torch.bridge``; inputs come from numpy seeds. On
the CPU the port runs the plain versions of its kernels: ``ops.mamba_scan`` is
the sequential oracle, ``impl="plain"`` the reference's chunked associative
scan.

Tolerances, each with its reason:

- ``mamba_scan``: the reference's own (tests/test_kernels.py), 1e-4 absolute
  and relative.
- Attention: the reference's kernel tolerances, 1e-5 in f32 and 3e-2 in bf16.
- Blocks and mixes: 1e-5 in f32 and 2e-2 in bf16 of the output's largest entry
  (fp32 sums in another order; in bf16 one ulp of an O(1) entry is 2**-7, and
  the SSM branch's entries reach 10).
- Logits in f32: 1e-3, ``forward`` and through the bf16 KV cache alike (as
  for the dense path, where a K on a bf16 rounding boundary moves a logit by
  about 1e-3). The reference's init takes the fan-in of ``wq``/``wk``/``wv``
  from the head axis, so attention scores have a std of about 90 and the
  softmax is nearly one-hot: f32 sums in another order move the attention
  output by 1e-5 of its size (about 1e-3 at 100) and the logits by up to
  2.3e-4.
- Logits in bf16: that near one-hot softmax turns one bf16 ulp of a q or k
  entry (0.03 at 8) into a score change of about 0.3, so bf16 rounding alone
  moves the reference's own logits by up to 1.2 from its f32 ones, and the
  two frameworks, which round at a few different places (each block agrees
  to within one bf16 ulp of its pieces), by up to 0.7; even the reference's
  jit and eager runs differ so. No elementwise bound says anything there. The
  bf16 logits are held to the reference's own bf16 accuracy instead, with
  its f32 run on the same weights and tokens as the yardstick: the RMS
  distance of the port's bf16 logits from the reference's f32 logits at most
  1.25 times the reference's bf16 logits' distance (measured 0.86-1.03), and
  the RMS gap between the two bf16 runs at most that distance (measured
  0.06-0.45 of it). A wrong block gives gaps of the logits' own size, about
  1, against distances of 0.02-0.35.
- Caches: K and V (bf16) one bf16 ulp of the tensor's largest entry in the
  f32 model (two frameworks round on either side of a boundary); in the bf16
  model the block tolerance, 2e-2 of the largest entry, since the second
  layer's K and V inherit the first layer's output differences (measured 0.5
  at entries of 47); the f32 SSM state 1e-5 of its largest
  entry in f32 and 2e-2 in bf16 (dt, B and x are rounded to bf16 before the
  scan); ``conv`` the same as block outputs.
- Served tokens: identical (greedy argmax of the f32 model).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api.tenants import AdapterStore as JaxAdapterStore  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import mamba_scan as jax_ms  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import kvcache as jax_kvcache  # noqa: E402
from repro.models import params as jax_prm  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api.tenants import AdapterStore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import mamba_scan as torch_ms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

BLOCK_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}     # of the output's largest entry
ATTN_ATOL = {"float32": 1e-5, "bfloat16": 3e-2}
LOGIT_ATOL = 1e-3                                     # f32 logits
BF16_ACCURACY_RATIO = 1.25     # bf16 logits: RMS from the f32 reference, over the reference's
BF16_GAP_RATIO = 1.0           # bf16 logits: RMS to the bf16 reference, over the same
SSM_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}        # of the state's largest entry
KV_RTOL = {"float32": 2.0 ** -7, "bfloat16": 2e-2}    # of the largest entry


def _configs(dtype: str):
    """The same reduced hymba-1.5b in both packages, with non-zero W_up."""
    out = []
    for get in (jax_get_config, get_config):
        cfg = get("hymba-1.5b").reduced(dtype=dtype)
        out.append(dataclasses.replace(
            cfg, adapter=dataclasses.replace(cfg.adapter, zero_init_up=False)))
    return out


@functools.lru_cache(maxsize=None)
def _models(dtype: str, seed: int = 0):
    """JAX-made weights and the port's copy; shared by the tests, which only read them."""
    jcfg, tcfg = _configs(dtype)
    defs = jax_prm.param_defs(jcfg)
    jparams = jax.jit(lambda k: jax_prm.materialize(defs, k, jcfg.dtype))(jax.random.key(seed))
    port = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, port


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close_rel(got, want, rtol):
    """|got - want| <= rtol * max|want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _logits_close(got, want, dtype, want_f32=None):
    """f32: elementwise within LOGIT_ATOL. bf16: against the RMS distance
    between the reference's bf16 logits ``want`` and its f32 logits
    ``want_f32``, the port's distance from ``want_f32`` within
    BF16_ACCURACY_RATIO of it and its gap to ``want`` within BF16_GAP_RATIO."""
    got, want = _np(got)[..., :500], _np(want)[..., :500]      # the pad logits are -1e30
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
        return
    rms = lambda x: float(np.sqrt(np.mean(np.square(x))))
    want_f32 = _np(want_f32)[..., :500]
    floor = rms(want - want_f32)                  # bf16 rounding's own effect
    assert rms(got - want_f32) <= BF16_ACCURACY_RATIO * floor, (rms(got - want_f32), floor)
    assert rms(got - want) <= BF16_GAP_RATIO * floor, (rms(got - want), floor)


def test_config_copy_matches_reference():
    for pick in (lambda g: g("hymba-1.5b"), lambda g: g("hymba-1.5b").reduced()):
        jc, tc = pick(jax_get_config), pick(get_config)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert jc.param_count() == tc.param_count()
        assert jc.padded_vocab == tc.padded_vocab
    full = get_config("hymba-1.5b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff, full.padded_vocab, full.sliding_window) == \
        (32, 1600, 25, 5, 64, 5504, 32256, 1024)
    assert (full.ssm.state_size, full.ssm.dt_rank, full.ssm.conv_width) == (16, 48, 4)
    assert full.param_count() == 1_241_806_400             # 2.48 GB in bf16
    small = get_config("hymba-1.5b").reduced()
    assert (small.d_model, small.n_heads, small.n_kv_heads, small.sliding_window,
            small.ssm.state_size, small.ssm.dt_rank, small.n_layers) == \
        (256, 4, 2, 128, 8, 16, 2)
    assert tfm.n_meta(small) == kvcache.n_sink(small) == 128


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bridge_carries_every_leaf_exactly(dtype):
    jcfg, tcfg, jparams, port = _models(dtype)
    shapes = prm.materialize(tcfg, seed=0, device="cpu")
    assert len(port["blocks"]) == tcfg.n_layers == 2
    assert set(port) == set(shapes) == {"embed", "final_norm", "head", "blocks", "meta"}
    for layer in range(tcfg.n_layers):
        got = dict(_leaves(port["blocks"][layer]))
        like = dict(_leaves(shapes["blocks"][layer]))
        want = dict(_leaves(jparams["blocks"][0]))
        assert set(got) == set(like) == set(want)
        assert {"/ssm/a_log", "/norm_attn", "/norm_ssm", "/attn/wo"} <= set(got)
        for name, t in got.items():
            np.testing.assert_array_equal(_np(t), np.asarray(want[name][layer, 0], np.float32))
            assert t.dtype == like[name].dtype and t.shape == like[name].shape
    for name in ("meta", "/embed/tok", "/head/w", "/final_norm/scale"):
        path = [p for p in name.split("/") if p]
        t, j, like = port, jparams, shapes
        for p in path:
            t, j, like = t[p], j[p], like[p]
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))
        assert t.dtype == like.dtype and t.shape == like.shape
    assert port["meta"].shape == (128, 256)
    # the Mamba A init: log(1..N) in every channel, as the reference's
    np.testing.assert_allclose(_np(shapes["blocks"][0]["ssm"]["a_log"]),
                               np.asarray(jparams["blocks"][0]["ssm"]["a_log"][0, 0],
                                          np.float32), rtol=1e-6)


def _scan_inputs(B, S, D, N, seed):
    """The reference's sweep inputs: unit-scale b and c, log decays -exp(x)."""
    rng = np.random.default_rng(seed)
    log_a = -np.exp(0.5 * rng.standard_normal((B, S, D, N), np.float32) - 1.0)
    b = 0.5 * rng.standard_normal((B, S, D, N), np.float32)
    c = rng.standard_normal((B, S, N), np.float32)
    return log_a.astype(np.float32), b.astype(np.float32), c


@pytest.mark.parametrize("B,S,D,N,chunk", [(2, 32, 8, 4, 8), (1, 64, 16, 8, 16),
                                           (3, 48, 4, 16, 16), (2, 37, 8, 8, 16)])
def test_mamba_scan_matches_reference_and_pallas(B, S, D, N, chunk):
    """The reference's sweep plus a ragged S of 37: the port's plain version
    against the reference's oracle and the Pallas kernel in interpret mode."""
    xs = _scan_inputs(B, S, D, N, seed=B * S + D * N)
    y, s = ops.mamba_scan(*map(torch.from_numpy, xs))
    assert y.shape == (B, S, D) and s.shape == (B, D, N)
    want = jax_ref.mamba_scan(*map(jnp.asarray, xs))
    pallas = jax_ms.mamba_scan(*map(jnp.asarray, xs), chunk=chunk, interpret=True)
    for got_, want_ in ((y, want[0]), (s, want[1]), (y, pallas[0]), (s, pallas[1])):
        np.testing.assert_allclose(_np(got_), _np(want_), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,S,D,N", [(2, 9, 8, 4), (1, 37, 16, 16)])
def test_mamba_scan_starts_from_state0(B, S, D, N):
    """A non-zero start state against a float64 numpy loop (1e-4, the
    reference's tolerance), and two halves chained through the state equal
    one pass."""
    log_a, b, c = _scan_inputs(B, S, D, N, seed=S + N)
    s0 = (3.0 * np.random.default_rng(S).standard_normal((B, D, N))).astype(np.float32)
    s, ys = s0.astype(np.float64), []
    for t in range(S):
        s = np.exp(log_a[:, t].astype(np.float64)) * s + b[:, t]
        ys.append(np.einsum("bdn,bn->bd", s, c[:, t]))
    xs = [torch.from_numpy(x) for x in (log_a, b, c, s0)]
    y, sT = ops.mamba_scan(*xs)
    np.testing.assert_allclose(_np(y), np.stack(ys, 1), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(sT), s, atol=1e-4, rtol=1e-4)
    h = S // 2
    y1, s1 = ops.mamba_scan(*(x[:, :h] for x in xs[:3]), xs[3])
    y2, s2 = ops.mamba_scan(*(x[:, h:] for x in xs[:3]), s1)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(s2), _np(sT), atol=1e-5, rtol=1e-5)
    zero, _ = ops.mamba_scan(*xs[:3])
    assert np.abs(_np(zero) - _np(y)).max() > 0.1          # state0 mattered
    torch_ms.check(*xs)
    with pytest.raises(ValueError, match="does not fit"):
        torch_ms.check(*xs[:3], xs[3][:, :, :1])
    with pytest.raises(ValueError, match="float32"):
        torch_ms.check(*xs[:3], xs[3].double())


def test_mamba_scan_launcher_takes_cuda_tensors_only():
    """No silent fallback, and the state sizes and dtype the kernel takes."""
    xs = [torch.from_numpy(x) for x in _scan_inputs(2, 8, 4, 16, seed=2)]
    with pytest.raises(ValueError, match="CUDA"):
        torch_ms.mamba_scan(*xs)
    torch_ms.check(*xs)
    bad = [torch.from_numpy(x) for x in _scan_inputs(2, 8, 4, 12, seed=2)]
    with pytest.raises(ValueError, match="state size"):
        torch_ms.check(*bad)
    with pytest.raises(ValueError, match="float32"):
        torch_ms.check(xs[0].double(), *xs[1:])
    with pytest.raises(ValueError, match="S >= 1"):
        torch_ms.check(*(x[:, :0] for x in xs))
    with pytest.raises(ValueError, match="does not fit"):
        torch_ms.check(xs[0], xs[1], xs[2][:, :, :8])
    ops.reset_launches()
    ops.mamba_scan(*xs)
    assert ops.LAUNCHES["mamba_scan"] == 0                # a CPU tensor is no launch


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_sinks_are_prefill_attend(dtype):
    """At 300 positions past a window of 128, the 128 sinks decide the result:
    the port's prefill attention equals the reference's ``_attend`` with
    n_sink = 128, and differs from attention without sinks."""
    B, S, H, K, hd, window = 2, 300, 4, 2, 64, 128
    rng = np.random.default_rng(7)
    x = [rng.standard_normal((B, S, n, hd), np.float32) for n in (H, K, K)]
    jq, jk, jv = (jnp.asarray(t).astype(dtype) for t in x)
    tq, tk, tv = (torch.from_numpy(t).to(getattr(torch, dtype)) for t in x)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    want = jax_blocks._attend(jq, jk, jv, pos, pos, causal=True, window=window,
                              n_sink=128, q_chunk=S)
    got = ops.flash_attention(tq, tk, tv, window=window, n_sink=128)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATTN_ATOL[dtype])
    no_sink = ops.flash_attention(tq, tk, tv, window=window)
    assert np.abs(_np(no_sink) - _np(got))[:, window:].max() > 0.2  # sinks matter past 128
    np.testing.assert_array_equal(_np(no_sink)[:, :window], _np(got)[:, :window])


def _cache_pair(jcfg, B, seq_len, rng, random: bool):
    """One layer's hymba cache in both packages: zero (fresh, as at prefill) or
    with random ``ssm``, ``conv``, K and V."""
    jc = jax.tree.map(lambda x: x[0, 0],
                      jax_kvcache.init_cache(jcfg, B, seq_len)["layers"][0])
    if random:
        scale = {"ssm": 3.0, "conv": 1.0, "k": 1.0, "v": 1.0}
        jc = {name: jnp.asarray(scale[name] * rng.standard_normal(x.shape)
                                .astype(np.float32)).astype(x.dtype)
              for name, x in jc.items()}
    tc = {name: bridge.to_tensor(np.asarray(x), "cpu") for name, x in jc.items()}
    return jc, tc


MIX_CASES = [("seq", "kernel"), ("seq", "plain"), ("prefill", "kernel"),
             ("prefill", "plain"), ("step", "kernel"), ("chunk", "kernel"),
             ("chunk", "plain")]


@pytest.mark.parametrize("mode,impl", MIX_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mamba_mix_matches_jax(dtype, mode, impl):
    """mamba_mix on the same input: 37 tokens with no cache ("seq"), 200 from
    a fresh cache ("prefill": two chunks of 100 in the plain form), one token
    against a random cache ("step"), or 9 tokens against a random cache
    ("chunk": the scan starts from its ``ssm``); y, and the new ``ssm`` and
    ``conv``."""
    jcfg, tcfg, jparams, port = _models(dtype)
    jp = jax.tree.map(lambda x: x[1, 0], jparams["blocks"][0])["ssm"]
    tp = port["blocks"][1]["ssm"]
    rng = np.random.default_rng(4)
    B, S = 2, {"seq": 37, "prefill": 200, "step": 1, "chunk": 9}[mode]
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    random = mode in ("step", "chunk")
    jc, tc = (None, None) if mode == "seq" else _cache_pair(jcfg, B, 8, rng, random)

    jy, jnc = jax.jit(lambda p, x, c: jax_blocks.mamba_mix(jcfg, p, x, c))(jp, xj, jc)
    ty, tnc = blocks.mamba_mix(tcfg, tp, xt, tc, impl=impl)
    assert ty.dtype == xt.dtype and ty.shape == (B, S, 256)
    _close_rel(ty, jy, BLOCK_RTOL[dtype])
    if mode == "seq":
        assert tnc is None
        return
    assert set(tnc) == {"k", "v", "ssm", "conv"} and tnc["ssm"].dtype == torch.float32
    _close_rel(tnc["ssm"], jnc["ssm"], SSM_RTOL[dtype])
    assert tnc["conv"].dtype == getattr(torch, str(jnc["conv"].dtype))
    _close_rel(tnc["conv"], jnc["conv"], BLOCK_RTOL[dtype])


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("mode", ["seq", "step"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_hymba_block_matches_jax(dtype, mode, impl):
    """apply_block("hymba") on the same input: 37 tokens ("seq"), or one token
    at position 20 against a random cache of 24 slots holding 0..19 ("step")."""
    jcfg, tcfg, jparams, port = _models(dtype)
    jp = jax.tree.map(lambda x: x[0, 0], jparams["blocks"][0])
    tp = port["blocks"][0]
    rng = np.random.default_rng(6)
    B = 2
    S = 37 if mode == "seq" else 1
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    if mode == "seq":
        pos = np.broadcast_to(np.arange(S), (B, S)).copy()
        jctx = jax_blocks.BlockCtx(cfg=jcfg, mode="seq", positions=jnp.asarray(pos))
        tctx = blocks.BlockCtx(cfg=tcfg, mode="seq", positions=torch.from_numpy(pos),
                               impl=impl)
        jc = tc = None
    else:
        jc, tc = _cache_pair(jcfg, B, 24, rng, random=True)
        kpos = np.where(np.arange(24) <= 20, np.arange(24), -1)[None].repeat(B, 0)
        pos, slot = np.full((B, 1), 20), np.full((B, 1), 20)
        jctx = jax_blocks.BlockCtx(cfg=jcfg, mode="step", positions=jnp.asarray(pos),
                                   cache_positions=jnp.asarray(kpos),
                                   write_slots=jnp.asarray(slot))
        tctx = blocks.BlockCtx(cfg=tcfg, mode="step", positions=torch.from_numpy(pos),
                               cache_positions=torch.from_numpy(kpos),
                               write_slots=torch.from_numpy(slot), impl=impl)
    jh, jnc, _ = jax.jit(lambda p, x, c: jax_blocks.apply_block("hymba", jcfg, p, x, jctx, c))(
        jp, xj, jc)
    th, tnc = blocks.apply_block("hymba", tcfg, tp, xt, tctx, tc)
    assert th.dtype == xt.dtype
    _close_rel(th, jh, BLOCK_RTOL[dtype])
    if mode == "step":
        assert set(tnc) == set(jnc) == {"k", "v", "ssm", "conv"}
        for name in ("k", "v"):
            _close_rel(tnc[name], jnc[name], KV_RTOL[dtype])
        _close_rel(tnc["ssm"], jnc["ssm"], SSM_RTOL[dtype])
        _close_rel(tnc["conv"], jnc["conv"], BLOCK_RTOL[dtype])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_logits_match_jax(dtype):
    """forward over 40 tokens: the meta rows go in front and are dropped
    before the head; both scan forms of the port against the reference."""
    jcfg, tcfg, jparams, port = _models(dtype)
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 40)).astype(np.int32)
    jforward = lambda cfg, p: jax.jit(lambda t: jax_tfm.forward(p, t, cfg)[0])(jnp.asarray(toks))
    want = jforward(jcfg, jparams)
    want_f32 = None
    if dtype == "bfloat16":
        jcfg32, _, jparams32, _ = _models("float32")
        want_f32 = jforward(jcfg32, jparams32)
    for impl in ("kernel", "plain"):
        got = tfm.forward(port, torch.from_numpy(toks).long(), tcfg, impl=impl)
        assert got.shape == (2, 40, tcfg.padded_vocab) and got.dtype == getattr(torch, dtype)
        _logits_close(got, want, dtype, want_f32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prefill_and_decode_match_reference(dtype):
    """prefill of 140 tokens (268 positions with the meta tokens, past the
    128 sinks + 128 window slots of a horizon of 300) and six decode steps;
    logits and every cache leaf. The ring buffer wraps in the prefill's
    gather-fill and again in decode, always past the sink slots."""
    jcfg, tcfg, jparams, port = _models(dtype)
    B, S, seq_len = 2, 140, 300
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    jit = lambda cfg: (jax.jit(lambda p, t: jax_tfm.prefill(p, t, cfg, seq_len=seq_len)),
                       jax.jit(lambda p, t, c: jax_tfm.decode_step(p, t, c, cfg)))
    jprefill, jdecode = jit(jcfg)
    # bf16: the reference's f32 run on the same tokens, for the bf16 logit check
    if dtype == "bfloat16":
        jcfg32, _, jparams32, _ = _models("float32")
        jprefill32, jdecode32 = jit(jcfg32)
        jl32, jc32 = jprefill32(jparams32, jnp.asarray(toks))
    else:
        jl32 = None

    jl, jc = jprefill(jparams, jnp.asarray(toks))
    tl, tc = tfm.prefill(port, torch.from_numpy(toks).long(), tcfg, seq_len=seq_len)
    assert tl.dtype == getattr(torch, dtype) and tl.shape == (B, tcfg.padded_vocab)
    assert tc["pos"].shape == (B, 256) and int(tc["next"][0]) == 268
    assert (tc["pos"][:, :128] == torch.arange(128)).all()      # the meta tokens' slots

    def check_cache():
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        np.testing.assert_array_equal(tc["next"].numpy(), np.asarray(jc["next"]))
        for i in range(tcfg.n_layers):
            layer = tc["layers"][i]
            want = jax.tree.map(lambda x: x[i, 0], jc["layers"][0])
            assert set(layer) == set(want) == {"k", "v", "ssm", "conv"}
            for name in ("k", "v"):
                assert layer[name].dtype == torch.bfloat16
                _close_rel(layer[name], want[name], KV_RTOL[dtype])
            assert layer["ssm"].dtype == torch.float32
            _close_rel(layer["ssm"], want["ssm"], SSM_RTOL[dtype])
            assert layer["conv"].dtype == getattr(torch, dtype)
            _close_rel(layer["conv"], want["conv"], BLOCK_RTOL[dtype])

    _logits_close(tl, jl, dtype, jl32)
    check_cache()
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    for _ in range(6):
        jl, jc = jdecode(jparams, jtok, jc)
        if jl32 is not None:
            jl32, jc32 = jdecode32(jparams32, jtok, jc32)
        tl, tc = tfm.decode_step(port, torch.tensor(np.asarray(jtok)).long(), tc, tcfg)
        _logits_close(tl, jl, dtype, jl32)
        check_cache()
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    assert int(tc["next"][0]) == 274 and (tc["pos"][:, :128] == torch.arange(128)).all()


def _requests(cls, vocab, tenants=(None,)):
    rng = np.random.default_rng(9)
    return [cls(i, rng.integers(0, vocab, size=int(rng.integers(5, 30))).astype(np.int32), 5,
                tenant=tenants[i % len(tenants)])
            for i in range(4)]


def test_batch_server_and_registry_match_reference(tmp_path):
    """Identical greedy tokens from both servers (f32 config) at a horizon
    that counts the 128 meta tokens, for the trunk and for a tenant whose
    adapter+head bundle the JAX AdapterStore wrote."""
    jcfg, tcfg, jparams, port = _models("float32")
    rng = np.random.default_rng(11)
    rnd = lambda x: jnp.asarray(0.05 * rng.standard_normal(x.shape, np.float32)).astype(x.dtype)
    bundle = {"adapter": jax.tree.map(rnd, jparams["blocks"][0]["adapter"]),
              "head": jax.tree.map(rnd, jparams["head"])}
    JaxAdapterStore(str(tmp_path)).put("t1", bundle, step=1)
    jreg = jax_serve.AdapterRegistry(jparams, JaxAdapterStore(str(tmp_path)))
    treg = serve.AdapterRegistry(port, AdapterStore(str(tmp_path)))
    assert treg.refresh() == ["t1"]
    grafted = treg.params_for("t1")
    assert grafted["meta"] is port["meta"]                          # shared trunk
    for layer in range(tcfg.n_layers):
        np.testing.assert_array_equal(_np(grafted["blocks"][layer]["adapter"]["w_down"]),
                                      np.asarray(bundle["adapter"]["w_down"][layer, 0]))
        assert grafted["blocks"][layer]["ssm"] is port["blocks"][layer]["ssm"]

    horizon = tfm.n_meta(tcfg) + 30 + 5 + 8
    tenants = (None, "t1")
    jsrv = jax_serve.BatchServer(jcfg, jparams, slots=2, horizon=horizon, registry=jreg)
    tsrv = serve.BatchServer(tcfg, port, slots=2, horizon=horizon, registry=treg, device="cpu")
    want = jsrv.run(_requests(jax_serve.Request, jcfg.vocab_size, tenants), log=lambda *a: None)
    got = tsrv.run(_requests(serve.Request, tcfg.vocab_size, tenants), log=lambda *a: None)
    assert got == want
    assert [b["rows"] for b in tsrv.batches] == [2, 2]


def test_cli_serves_hymba_on_cpu(capsys):
    serve.main(["--arch", "hymba-1.5b", "--device", "cpu", "--requests", "3", "--slots", "2",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "on cpu" in out
