"""The port's mixture-of-experts block against the JAX package, on the CPU.

Reduced olmoe-1b-7b (d 256, 4 heads of 64 in MHA, 4 experts top 2, d_expert
128, 2 layers) and reduced llama4-maverick (one dense and one moe layer, 4
query heads over 2, 4 experts top 1, a window of 128), adapter m 16 with a
non-zero W_up. JAX materialises the weights (wq, wk and wv then scaled to
the fan-in init, as in tests/test_torch_ring.py, which says why) and
``repro_torch.bridge`` carries them across; both packages get the same numpy inputs. On the CPU
the port runs the plain versions of its kernels.

Routing. One ulp of difference before the router can send a token to
another expert, which moves its output by a whole gate-weighted expert, so
the tests hold routing first:

  * f32: the experts each token picks, and which assignments the capacity
    drops, equal in both packages (exactly), then the values at 1e-5 of the
    largest entry (f32 sums in other orders);
  * bf16: the router's logits are bf16, so exact ties are common; the
    experts picked are compared, the share of tokens routed differently is
    printed, and the tokens routed alike are held to the bf16 tolerance. A
    token counts as routed alike where, in every moe layer, it and every
    earlier token of its row (which reach it through causal attention) got
    the same experts with the same drops, and no earlier token of its row was
    routed differently in a moe layer before the last (attention carries
    that to the later tokens). At least 3/4 of the tokens of every moe call
    must be routed alike: a wrong block would route most of them elsewhere
    (a random choice of 2 of 4 experts matches one time in 6).

Capacity depends on each call's token count (C = max(8, ceil(T k / E cf)
rounded up to 8)), so a sequence, a prompt and a decode step drop different
tokens: each path is held to the reference's same path, never to another.

bf16 tolerances: 5e-2 absolute on logits (the serving tests' bf16
tolerance: bf16 rounding at other places, over two layers); 2**-6 of the
largest entry (two bf16 ulps of it) on a block's and the experts' outputs,
whose residual stream reaches magnitudes where one ulp exceeds 5e-2.

The ring on a moe model, the four configs, the bridge and the smoke runs
of every new arch are in tests/test_torch_archs.py.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import training as jax_training  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import params as jax_prm  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import training  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

RTOL = 1e-5              # f32: values, of the largest entry
RTOL_GRAD = 5e-4         # f32: gradients and moments through the layers, of the largest entry
ATOL_BF16 = 5e-2         # bf16: logits, absolute
RTOL_BF16 = 2.0 ** -6    # bf16: block and expert outputs, of the largest entry
ALIKE_MIN = 0.75         # bf16: the least share of tokens routed alike
OLMOE, LLAMA4 = "olmoe-1b-7b", "llama4-maverick-400b-a17b"
B, S = 2, 24


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
    pattern entry (tests/test_torch_ring.py says why)."""
    scale = np.sqrt(cfg.n_heads / cfg.d_model)
    blocks_ = tuple({**e, "attn": {k: (v * scale).astype(v.dtype) if k in ("wq", "wk", "wv")
                                   else v for k, v in e["attn"].items()}}
                    for e in p["blocks"])
    return {**p, "blocks": blocks_}


@functools.lru_cache(maxsize=None)
def _jax_params(arch, dtype="float32"):
    """JAX's parameters (numpy leaves, read only), wq, wk, wv at the fan-in
    scale; in bf16 the f32 ones rounded (each materialisation takes JAX about
    12 s on one core), the f32 leaves (norm scales) kept."""
    cfg = _configs(arch, dtype)[0]
    if dtype != "float32":
        leaves, tree = jax.tree.flatten(_jax_params(arch))
        defs = jax.tree.leaves(jax_prm.param_defs(cfg), is_leaf=lambda x: isinstance(x, jax_prm.PD))
        return jax.tree.unflatten(tree, [x if pd.dtype else np.asarray(jnp.asarray(x, dtype))
                                         for x, pd in zip(leaves, defs, strict=True)])
    return _fan_in(jax.tree.map(np.asarray, jax_prm.materialize(
        jax_prm.param_defs(cfg), jax.random.key(0), cfg.dtype)), cfg)


def _port(arch, dtype="float32"):
    return bridge.params_from_jax(_jax_params(arch, dtype), _configs(arch, dtype)[1],
                                  device="cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rtol=RTOL, what="", mask=None):
    """max |got - want| <= rtol x max |want| (over the rows of ``mask``)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if mask is not None:
        got, want = got[mask], want[mask]
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max())
    assert gap <= rtol * scale, f"{what}: {gap} > {rtol} x {scale}"


def _close_abs(got, want, atol, what="", mask=None):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if mask is not None:
        got, want = got[mask], want[mask]
    gap = float(np.abs(got - want).max())
    assert gap <= atol, f"{what}: {gap} > {atol}"


# ---------------------------------------------------------------- routing records


def _kept(eidx: np.ndarray, n_experts: int, capacity: int) -> np.ndarray:
    """[T, k] bool: whether each assignment keeps its slot (a token meets an
    expert once, so its rank is the number of earlier tokens picking it)."""
    seen = np.zeros(n_experts, np.int64)
    keep = np.zeros(eidx.shape, bool)
    for t in range(eidx.shape[0]):
        for j, e in enumerate(eidx[t]):
            keep[t, j] = seen[e] < capacity
            seen[e] += 1
    return keep


def _routes_alike(a: np.ndarray, b: np.ndarray, n_experts: int, capacity: int) -> np.ndarray:
    """[T] bool: the same experts with the same drops (the order of a token's
    k choices does not matter)."""
    ka, kb = _kept(a, n_experts, capacity), _kept(b, n_experts, capacity)
    pa = np.sort(a * 2 + ka, axis=1)
    pb = np.sort(b * 2 + kb, axis=1)
    return (pa == pb).all(axis=1)


@pytest.fixture
def port_routes(monkeypatch):
    """Every expert choice ``blocks.moe_topk`` makes, in call order."""
    seen = []
    real = blocks.moe_topk

    def spy(probs, k):
        gates, eidx = real(probs, k)
        seen.append(eidx.numpy().copy())
        return gates, eidx

    monkeypatch.setattr(blocks, "moe_topk", spy)
    return seen


@pytest.fixture
def jax_routes(monkeypatch):
    """Every expert choice the JAX package's dispatch makes, in call order
    (``lax.top_k`` of the same probabilities, through a host callback)."""
    seen = []
    real = jax_blocks._moe_dispatch_group

    def spy(cfg, p, xt, C):
        logits = (xt @ p["router"].astype(xt.dtype)).astype(jnp.float32)
        _, eidx = lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.moe.top_k)
        jax.debug.callback(lambda e: seen.append(np.asarray(e)), eidx)
        return real(cfg, p, xt, C)

    monkeypatch.setattr(jax_blocks, "_moe_dispatch_group", spy)
    return seen


def _alike_tokens(port_seen, jax_seen, cfg, shape, dtype):
    """[B, S] mask of the tokens whose logits compare: routed alike in every
    moe call, and no earlier token of their row routed differently in a moe
    call before the last (attention in the next layer carries that to the
    later tokens). In f32 every token must be routed alike; in bf16 at least
    ALIKE_MIN of the (call, token) pairs. Prints both shares."""
    jax.effects_barrier()                     # the callbacks of JAX's asynchronous dispatch
    assert len(port_seen) == len(jax_seen) > 0
    Bn, Sn = shape
    C = blocks.moe_capacity(cfg, Bn * Sn)
    dirty = np.zeros((Bn, Sn), bool)
    pairs = []
    for i, (a, b) in enumerate(zip(port_seen, jax_seen)):
        same = _routes_alike(a, b, cfg.moe.n_experts, C).reshape(Bn, Sn)
        pairs.append(same)
        dirty |= ~same
        if i + 1 < len(port_seen):
            dirty = np.logical_or.accumulate(dirty, axis=1)
    share = float(np.mean(pairs))
    print(f"[moe routing] {cfg.name} {dtype} {Bn}x{Sn}: {1 - share:.4f} of the tokens routed "
          f"differently over {len(pairs)} moe calls, {float(np.mean(~dirty)):.4f} held")
    if dtype == "float32":
        assert share == 1.0, "f32 routing differs from the reference's"
    assert share >= ALIKE_MIN, f"only {share} of the tokens are routed alike"
    return ~dirty


def _port_cache(jc, cfg):
    """The JAX package's cache in the port's layout (one dict per layer)."""
    conv = lambda x: bridge.to_tensor(np.asarray(x), "cpu")
    return {"layers": bridge._unstack_entries(jc["layers"], cfg, conv),
            "pos": conv(jc["pos"]).long(), "next": conv(jc["next"]).long()}


# ---------------------------------------------------------------- moe_ffn

FFN_CASES = {
    # name: (capacity factor, router scale): 1.25 the configs'; 0.5 drops
    # many assignments; a router of zeros ties every probability, so every
    # token picks experts 0 and 1 (the lower indices) and capacity overflows
    "random": (1.25, 1.0),
    "tight": (0.5, 1.0),
    "zero_router": (1.25, 0.0),
}


def _ffn_case(case, dtype):
    cf, scale = FFN_CASES[case]
    jcfg, tcfg = _configs(OLMOE, dtype)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
    jp = dict(_jax_params(OLMOE, dtype)["blocks"][0]["moe"])
    jp = {k: v[0, 0] for k, v in jp.items()}
    jp["router"] = (jp["router"].astype(np.float32) * scale).astype(jp["router"].dtype)
    tp = {k: bridge.to_tensor(v, "cpu") for k, v in jp.items()}
    x = np.random.default_rng(3).standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_jax_in_f32(case, port_routes, jax_routes):
    """Output, moe_aux, moe_z and the input gradient (through the gates'
    softmax and the experts) against jax.grad, routing exact."""
    jcfg, tcfg, jp, tp, x = _ffn_case(case, "float32")
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jloss(xx):
        out, aux = jax_blocks.moe_ffn(jcfg, jp, xx)
        return jnp.sum(out * cot) + aux["moe_aux"] + aux["moe_z"], (out, aux)

    (_, (want, want_aux)), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got, aux = blocks.moe_ffn(tcfg, tp, xt)
    (g,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum() + aux["moe_aux"]
                               + aux["moe_z"], xt)
    _alike_tokens(port_routes, jax_routes, tcfg, (B, S), "float32")
    _close(got, want, what="out")
    _close(aux["moe_aux"], want_aux["moe_aux"], what="moe_aux")
    _close(aux["moe_z"], want_aux["moe_z"], what="moe_z")
    _close(g, want_g, what="input gradient")
    keep = _kept(port_routes[0], tcfg.moe.n_experts, blocks.moe_capacity(tcfg, B * S))
    if case == "random":
        assert keep.all()                       # 48 tokens of 2 choices: 32 slots an expert
    else:
        assert not keep.all()                   # the drops are part of what is held
    if case == "zero_router":
        assert (port_routes[0] == [0, 1]).all()


@pytest.mark.parametrize("case", ["random", "zero_router"])
def test_moe_ffn_in_bf16_holds_the_tokens_routed_alike(case, port_routes, jax_routes):
    jcfg, tcfg, jp, tp, x = _ffn_case(case, "bfloat16")
    want, want_aux = jax.jit(lambda xx: jax_blocks.moe_ffn(jcfg, jp, xx))(
        jnp.asarray(x, jnp.bfloat16))
    got, aux = blocks.moe_ffn(tcfg, tp, torch.from_numpy(x).bfloat16())
    alike = _alike_tokens(port_routes, jax_routes, tcfg, (B, S), "bfloat16")
    assert got.dtype == torch.bfloat16
    _close(got, want, RTOL_BF16, "out", mask=alike)
    for k in ("moe_aux", "moe_z"):                # f32 of the bf16 logits
        _close(aux[k], want_aux[k], rtol=1e-3, what=k)


# ---------------------------------------------------------------- port invariants

INVARIANT_CASES = [(16, 4, 2, 0), (37, 8, 3, 1), (64, 16, 1, 2), (5, 4, 4, 3), (128, 8, 2, 4)]


@pytest.mark.parametrize("T,E,k,seed", INVARIANT_CASES)
def test_moe_dispatch_invariants(T, E, k, seed):
    """tests/test_property.py::test_moe_dispatch_invariants for the port: at a
    capacity factor that drops nothing the output equals the dense
    all-experts combination with the same gates; then at a tight capacity,
    the dispatch maps: every kept assignment owns one slot and the slot names
    it back, each expert keeps min(its count, C) in token order, and the
    result is the same bit for bit on a second call."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.models import params as prm

    def cfg_at(cf):
        return ModelConfig(name=f"t{seed}", family="moe", n_layers=1, d_model=16, n_heads=2,
                           n_kv_heads=2, d_ff=32, vocab_size=64, pattern=(("moe", 1),),
                           dtype="float32",
                           moe=MoEConfig(n_experts=E, top_k=k, d_expert=16, capacity_factor=cf))

    cfg = cfg_at(8.0)
    gen = torch.Generator().manual_seed(seed)
    p = {name: prm._init_leaf(pd, torch.float32, gen, torch.device("cpu"))
         for name, pd in prm.moe_defs(cfg).items()}
    x = torch.randn(1, T, 16, generator=gen)
    out, aux = blocks.moe_ffn(cfg, p, x)
    assert out.shape == x.shape and torch.isfinite(out).all() and aux["moe_aux"] >= 0
    xt = x.reshape(T, 16)
    gates, eidx = blocks.moe_topk(torch.softmax(xt @ p["router"], -1), k)
    gates = gates / gates.sum(-1, keepdim=True)
    act = torch.nn.functional.silu
    dense = torch.zeros_like(xt)
    for e in range(E):
        ye = (act(xt @ p["we_gate"][e]) * (xt @ p["we_up"][e])) @ p["we_down"][e]
        dense += ((eidx == e) * gates).sum(-1)[:, None] * ye
    shared = (act(xt @ p["ws_gate"]) * (xt @ p["ws_up"])) @ p["ws_down"]
    torch.testing.assert_close(out[0], dense + shared, atol=1e-4, rtol=1e-4)

    C = 8                                     # the least capacity: drops at these T k / E
    slot, src, keep = blocks.moe_slots(eidx, E, C)
    flat = eidx.reshape(-1)
    kept = torch.nonzero(keep).reshape(-1)
    assert len(set(slot[kept].tolist())) == len(kept)                # one slot each
    assert torch.equal(src[slot[kept]], kept)                       # named back
    assert bool((slot[~keep] == E * C).all())
    assert int((src < T * k).sum()) == len(kept)
    for e in range(E):
        mine = torch.nonzero(flat == e).reshape(-1)
        assert torch.equal(keep[mine], torch.arange(len(mine)) < C)  # token order
        assert torch.equal(slot[mine[:C]], e * C + torch.arange(min(C, len(mine))))
    again = blocks.moe_ffn(cfg_at(0.1), p, x)
    assert torch.equal(again[0], blocks.moe_ffn(cfg_at(0.1), p, x)[0])


def test_ties_go_to_the_lower_expert():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                          [0.3, 0.1, 0.3, 0.3]])
    _, eidx = blocks.moe_topk(probs, 2)
    assert eidx.tolist() == [[0, 1], [1, 2], [0, 2]]
    want = lax.top_k(jnp.asarray(probs.numpy()), 2)[1]
    assert eidx.tolist() == np.asarray(want).tolist()


# ---------------------------------------------------------------- the block and the model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_jax(dtype, port_routes, jax_routes):
    """apply_block("moe") on the same input: the block output and its aux."""
    jcfg, tcfg = _configs(OLMOE, dtype)
    jp = jax.tree.map(lambda v: v[0, 0], _jax_params(OLMOE, dtype)["blocks"][0])
    tp = bridge.params_from_jax(_jax_params(OLMOE, dtype), tcfg, device="cpu")["blocks"][0]
    x = np.random.default_rng(5).standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    jctx = jax_blocks.BlockCtx(cfg=jcfg, mode="seq", positions=jnp.asarray(pos),
                               causal=True, impl="jnp")
    want, _, want_aux = jax.jit(lambda xx: jax_blocks.apply_block("moe", jcfg, jp, xx, jctx))(
        jnp.asarray(x, jcfg.dtype))
    tctx = blocks.BlockCtx(cfg=tcfg, mode="seq", positions=torch.from_numpy(pos.copy()))
    got, cache, aux = blocks.apply_block("moe", tcfg, tp, torch.from_numpy(x).to(
        getattr(torch, dtype)), tctx)
    assert cache is None and set(aux) == {"moe_aux", "moe_z"}
    alike = _alike_tokens(port_routes, jax_routes, tcfg, (B, S), dtype)
    if dtype == "float32":
        _close(got, want, what="block")
        for k in aux:
            _close(aux[k], want_aux[k], what=k)
    else:
        _close(got, want, RTOL_BF16, "block", mask=alike)


def _tokens(seed=6, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [OLMOE, LLAMA4])
def test_forward_matches_jax(arch, dtype, port_routes, jax_routes):
    """The logits and the layers' summed moe_aux and moe_z; at boundary 1
    the frozen layers' aux arrive without gradient."""
    jcfg, tcfg = _configs(arch, dtype)
    jp, tp = _jax_params(arch, dtype), _port(arch, dtype)
    toks = _tokens()
    want, want_aux = jax.jit(lambda t: jax_tfm.forward(jp, t, jcfg, impl="jnp"))(
        jnp.asarray(toks))
    got, aux = tfm.forward(tp, torch.from_numpy(toks).long(), tcfg)
    alike = _alike_tokens(port_routes, jax_routes, tcfg, (B, S), dtype)
    if dtype == "float32":
        _close(got, want, what="logits")
        for k in ("moe_aux", "moe_z"):
            _close(aux[k], want_aux[k], what=k)
        assert float(aux["moe_aux"]) > 0 and float(aux["moe_z"]) > 0
    else:
        _close_abs(got, want, ATOL_BF16, "logits", mask=alike)
    _, frozen_aux = tfm.forward(tp, torch.from_numpy(toks).long(), tcfg, boundary=1)
    assert not any(v.requires_grad for v in frozen_aux.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [OLMOE, LLAMA4])
def test_prefill_and_decode_match_jax(arch, dtype, port_routes, jax_routes):
    """A 20-token prompt, then two decode steps (T = B tokens a step, C = 8),
    each against the reference's same path. Both caches are bf16, and a K or
    V that lies on a bf16 rounding boundary rounds to either side in the two
    frameworks (f32 sums in other orders): the prefill caches are held to one
    bf16 ulp of each tensor's largest entry, and each decode step runs from
    the reference's cache, carried across."""
    jcfg, tcfg = _configs(arch, dtype)
    jp, tp = _jax_params(arch, dtype), _port(arch, dtype)
    toks = _tokens(7, (B, 20))
    seq_len = 32
    jl, jc = jax.jit(lambda t: jax_tfm.prefill(jp, t, jcfg, seq_len=seq_len, impl="jnp"))(
        jnp.asarray(toks))
    jdecode = jax.jit(lambda t, c: jax_tfm.decode_step(jp, t, c, jcfg, impl="jnp"))
    tl, tc = tfm.prefill(tp, torch.from_numpy(toks).long(), tcfg, seq_len=seq_len)
    alike = _alike_tokens(port_routes, jax_routes, tcfg, (B, 20), dtype)
    if dtype == "float32":
        _close(tl, jl, what="prefill logits")
        for i, (mine, theirs) in enumerate(zip(tc["layers"], _port_cache(jc, tcfg)["layers"])):
            for k in ("k", "v"):
                _close(mine[k], theirs[k], 2.0 ** -7, f"layer {i} cache {k}")
    else:
        _close_abs(tl, jl, ATOL_BF16, "prefill logits", mask=alike[:, -1])
    for step in range(2):
        del port_routes[:], jax_routes[:]
        nxt = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
        tc = _port_cache(jc, tcfg)
        jl, jc = jdecode(jnp.asarray(nxt), jc)
        tl, tc = tfm.decode_step(tp, torch.from_numpy(nxt).long(), tc, tcfg)
        # from the same cache: the step's own logits, routing exact in f32
        step_alike = _alike_tokens(port_routes, jax_routes, tcfg, (B, 1), dtype)
        if dtype == "float32":
            _close(tl, jl, what=f"decode step {step} logits")
        else:
            _close_abs(tl, jl, ATOL_BF16, f"decode step {step} logits", mask=step_alike[:, 0])


# ---------------------------------------------------------------- the LM step


def test_lm_step_matches_jax():
    """Reduced olmoe in f32 at boundary 0 (the backward through both moe
    layers): one step of each package from fresh moments. The loss, moe_aux
    and moe_z of the step's metrics (reported, detached, not added to the
    loss: the loss equals the cross-entropy of ``loss_and_grads``), and the
    gradients of the head and every adapter against the JAX step's, read
    from its first moments (m = (1 - beta1) g)."""
    jcfg, tcfg = _configs(OLMOE)
    jp, tp = _jax_params(OLMOE), _port(OLMOE)
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, 512, (B, S)).astype(np.int32),
             "labels": rng.integers(0, 512, (B, S)).astype(np.int32)}
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    jtc, tc = JaxTrainConfig(), TrainConfig()
    jstep = jax.jit(jax_training.make_train_step(jcfg, jtc, 0))
    _, jopt, jm = jstep(jp, jax_adamw.init(jax_training.full_trainable(jp)),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    _, _, m = training.make_train_step(tcfg, tc, 0)(
        tp, adamw.init(training.full_trainable(tp, tcfg)), tb)
    assert {"loss", "moe_aux", "moe_z", "grad_norm"} <= set(m)
    assert not any(v.requires_grad for v in m.values())
    for k in ("loss", "moe_aux", "moe_z"):
        _close(m[k], jm[k], what=k)
    _close(m["grad_norm"], jm["grad_norm"], RTOL_GRAD, "grad_norm")
    loss, metrics, grads = training.loss_and_grads(tp, tb, tcfg, 0)
    assert float(loss) == float(metrics["loss"]) == float(m["loss"])
    scale = 1.0 / (1.0 - jtc.beta1)
    _close(grads["head"]["w"], np.asarray(jopt["m"]["head"]["w"]) * scale, RTOL_GRAD, "head")
    for i, g in enumerate(grads["adapters"]):
        for k, t in g.items():
            want = np.asarray(jopt["m"]["adapters"][0][k][i, 0]) * scale
            _close(t, want, RTOL_GRAD, f"layer {i} {k}")
