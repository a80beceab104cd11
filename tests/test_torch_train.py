"""The port's training path against the JAX package, on the CPU.

Reduced stablelm-3b (d 256, 4 heads over 4, head_dim 64) and qwen2.5-3b (4
query heads over 2 KV heads, a window of 128), 2 layers each, adapter m 16,
in f32. Both packages get the same parameters: JAX materialises them and the
adapters are then perturbed from a numpy seed, so that W_up != 0 (a
zero-initialised W_up makes g_mid and dW_down exactly 0). Both get the same
numpy batches. On the CPU the port runs the plain versions of its kernels,
forward and backward.

Tolerances (f32): the loss 1e-5 relative; the logits 5e-5 of their largest
entry (f32 sums in other orders through two layers and a head of 512
products: the largest gap seen is 1.7e-5, the RMS gap 5e-6); gradients 5e-4
of the leaf's largest entry (the reduced qwen2.5-3b's lower adapter differs
from JAX's by 1.1e-4 of it, and by as much under torch's own autograd of the
plain forwards: f32 sums in other orders through a layer's backward). The
parameters after a step: 5e-4 of the leaf's largest entry, and where a
gradient entry lies within that gap of 0, 2 lr for each step so far: Adam's
first steps move a parameter by about lr in the direction of its gradient's
sign whatever its size, and the two frameworks may give such an entry either
sign. Rows below the boundary are held bit for bit. The plain backward versions: f32 1e-5 of the largest entry;
bf16 one bf16 ulp of the largest entry (2**-7 relative, another place of
rounding) for the adapter, and 2**-6 for attention, whose reference rounds dP
to bf16 before the softmax backward where the formula keeps it in fp32.
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
from repro.core import unfreeze as jax_unfreeze  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import losses as jax_losses  # noqa: E402
from repro.models import params as jax_prm  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import training  # noqa: E402
from repro_torch.core import unfreeze  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import losses  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCHS = ["stablelm-3b", "qwen2.5-3b"]
RTOL_FWD = 1e-5      # the loss and the metrics, relative
RTOL_LOGITS = 5e-5   # logits, of the largest entry
RTOL_GRAD = 5e-4     # gradients and parameters after a step, of the leaf's largest entry
B, S = 2, 24


def _configs(arch, dtype="float32"):
    return jax_get_config(arch).reduced(dtype=dtype), get_config(arch).reduced(dtype=dtype)


def _jax_params(cfg, seed=0):
    """JAX's parameters with the adapters perturbed from a numpy seed (W_up != 0)."""
    return _jax_params_of(cfg.name, cfg.dtype, seed)


@functools.lru_cache(maxsize=None)
def _jax_params_of(arch, dtype, seed):
    """Made once per (arch, dtype, seed): numpy leaves, which no test writes to."""
    cfg = jax_get_config(arch).reduced(dtype=dtype)
    p = jax.tree.map(np.asarray, jax_prm.materialize(jax_prm.param_defs(cfg),
                                                     jax.random.key(seed), cfg.dtype))
    rng = np.random.default_rng(seed + 1)
    blocks = []
    for e in p["blocks"]:
        ad = {k: (v.astype(np.float32) + 0.05 * rng.standard_normal(v.shape)).astype(v.dtype)
              for k, v in e["adapter"].items()}
        blocks.append({**e, "adapter": ad})
    return {**p, "blocks": tuple(blocks)}


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _port_batch(batch):
    return pipeline.to_device(batch, "cpu")


def _close(got, want, rtol, what="", slack=None):
    """max |got - want| <= rtol x max |want|, plus ``slack`` elementwise."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    excess = np.abs(got - want) - rtol * scale - (0.0 if slack is None else slack)
    assert float(excess.max()) <= 0, f"{what}: {float(np.abs(got - want).max())} > {rtol} x " \
        f"{scale} (+ slack) by {float(excess.max())}"


def _adapter_rows(tree_entry, layer):
    """Layer ``layer``'s adapter from a JAX adapter tree [R, 1, ...] (dense pattern)."""
    return {k: v[layer, 0] for k, v in tree_entry.items()}


# ---------------------------------------------------------------- forward, gradients


@pytest.mark.parametrize("boundary", [0, 1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_boundary_matches_jax(arch, boundary):
    jcfg, tcfg = _configs(arch)
    jp = _jax_params(jcfg)
    tp = bridge.params_from_jax(jp, tcfg, device="cpu")
    batch = _batch(tcfg)
    want, _ = jax_tfm.forward(jp, jnp.asarray(batch["tokens"]), jcfg, boundary=boundary,
                              impl="jnp")
    got, _ = tfm.forward(tp, _port_batch(batch)["tokens"], tcfg, boundary=boundary)
    _close(got, want, RTOL_LOGITS, f"logits at boundary {boundary}")


@pytest.mark.parametrize("boundary", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_hot_gradients_match_jax_grad(arch, boundary):
    """The head's and the hot adapters' gradients against jax.grad of the same
    loss; the frozen trunk saves nothing for autograd."""
    jcfg, tcfg = _configs(arch)
    jp = _jax_params(jcfg)
    tp = bridge.params_from_jax(jp, tcfg, device="cpu")
    batch = _batch(tcfg)

    def loss_fn(tr):
        logits, _ = jax_tfm.forward(jp, jnp.asarray(batch["tokens"]), jcfg, boundary=boundary,
                                    impl="jnp", hot_adapters=tr["adapters"],
                                    head_params=tr["head"])
        return jax_losses.cross_entropy(logits, jnp.asarray(batch["labels"]))[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(jax_training.split_trainable(jp, boundary))
    loss, metrics, grads = training.loss_and_grads(tp, _port_batch(batch), tcfg, boundary)
    _close(loss, jloss, RTOL_FWD, "loss")
    assert set(metrics) == {"loss", "accuracy", "tokens"} and float(metrics["tokens"]) == B * S
    _close(grads["head"]["w"], jgrads["head"]["w"], RTOL_GRAD, "head")
    assert len(grads["adapters"]) == tcfg.n_layers - boundary
    for i, ga in enumerate(grads["adapters"]):
        want = _adapter_rows(jgrads["adapters"][0], i)
        for leaf in ("w_down", "w_up"):
            assert float(np.abs(want[leaf]).max()) > 0
            _close(ga[leaf], want[leaf], RTOL_GRAD, f"layer {boundary + i} {leaf}")


def test_frozen_trunk_saves_nothing_for_autograd():
    """Below the boundary nothing requires a gradient: the hot region's input
    is detached, and only the trainable leaves reach the loss's graph."""
    _, tcfg = _configs("qwen2.5-3b")
    tp = bridge.params_from_jax(_jax_params(_configs("qwen2.5-3b")[0]), tcfg, device="cpu")
    seen = []
    real = tfm.apply_block

    def spy(kind, cfg, p, h, ctx, cache=None):
        seen.append((torch.is_grad_enabled(), h.requires_grad))
        return real(kind, cfg, p, h, ctx, cache)

    tfm.apply_block = spy
    try:
        training.loss_and_grads(tp, _port_batch(_batch(tcfg)), tcfg, boundary=1)
    finally:
        tfm.apply_block = real
    assert seen == [(False, False), (True, False)]


# ---------------------------------------------------------------- the train step


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_with_walking_boundary_match_jax(arch):
    """Depths 1, 1, 2 at interval 1: the boundary walks 1 -> 1 -> 0. Losses
    and the updated parameters against the JAX step and adamw.update; the
    frozen layer's adapter and moments stay bit-identical while frozen."""
    jcfg, tcfg = _configs(arch)
    jtc, tc = JaxTrainConfig(warmup_steps=2), TrainConfig(warmup_steps=2)
    jp = _jax_params(jcfg)
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
        jstep = jax_training.make_train_step(jcfg, jtc, boundary)
        step = training.make_train_step(tcfg, tc, boundary)
        for s in range(start, end):
            batch = _batch(tcfg, seed=10 + s)
            before = [{k: t.clone() for k, t in b["adapter"].items()} for b in tp["blocks"]]
            m_before = [{k: t.clone() for k, t in a.items()} for a in opt["m"]["adapters"]]
            jm_old = jopt["m"]
            jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
            tp, opt, m = step(tp, opt, _port_batch(batch))
            lr = float(jax_adamw.lr_at(jtc, jopt["count"]))
            _close(m["loss"], jm["loss"], RTOL_FWD, f"step {s} loss")
            _close(m["grad_norm"], jm["grad_norm"], RTOL_GRAD, f"step {s} grad norm")
            add_slack("head", jm_old["head"]["w"], jopt["m"]["head"]["w"], lr)
            _close(tp["head"]["w"], jp["head"]["w"], RTOL_GRAD, f"step {s} head",
                   slack["head"])
            for i, b in enumerate(tp["blocks"]):
                for leaf, t in b["adapter"].items():
                    if i >= boundary:
                        add_slack((i, leaf), jm_old["adapters"][0][leaf][i, 0],
                                  jopt["m"]["adapters"][0][leaf][i, 0], lr)
                    _close(t, jp["blocks"][0]["adapter"][leaf][i, 0], RTOL_GRAD,
                           f"step {s} layer {i} {leaf}", slack.get((i, leaf)))
                    if i < boundary:
                        assert torch.equal(t, before[i][leaf])
                        assert torch.equal(opt["m"]["adapters"][i][leaf], m_before[i][leaf])
                    else:
                        assert not torch.equal(t, before[i][leaf])
            assert int(opt["count"]) == int(jopt["count"]) == s + 1
    # the optimizer state carried back to the reference's layout
    # (v holds squares of gradients: twice their relative gap)
    back = bridge.opt_state_to_jax(opt, tcfg)
    for k, rtol in (("m", RTOL_GRAD), ("v", 2 * RTOL_GRAD)):
        _close(back[k]["head"]["w"], jopt[k]["head"]["w"], rtol, f"{k} head")
        for leaf in ("w_down", "w_up"):
            _close(back[k]["adapters"][0][leaf], jopt[k]["adapters"][0][leaf], rtol,
                   f"{k} adapters {leaf}")


def test_eval_step_and_chunked_cross_entropy_match_jax():
    jcfg, tcfg = _configs("qwen2.5-3b")
    jp = _jax_params(jcfg)
    tp = bridge.params_from_jax(jp, tcfg, device="cpu")
    batch = _batch(tcfg)
    want = jax_training.make_eval_step(jcfg)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = training.make_eval_step(tcfg)(tp, _port_batch(batch))
    for key in ("loss", "accuracy", "tokens"):
        _close(got[key], want[key], RTOL_FWD, key)
    # the chunked form (checkpointed chunks of the sequence), with a mask
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 32, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 32)).astype(np.int32)
    mask = (rng.random((2, 32)) > 0.3).astype(np.float32)
    jl, jmet = jax_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                        jnp.asarray(mask), chunk=8)
    lt = torch.from_numpy(logits).requires_grad_(True)
    tl, tmet = losses.cross_entropy(lt, torch.from_numpy(labels), torch.from_numpy(mask),
                                    chunk=8)
    _close(tl, jl, RTOL_FWD, "chunked loss")
    _close(tmet["accuracy"], jmet["accuracy"], RTOL_FWD, "chunked accuracy")
    jg = jax.grad(lambda x: jax_losses.cross_entropy(x, jnp.asarray(labels), jnp.asarray(mask),
                                                     chunk=8)[0])(jnp.asarray(logits))
    (tg,) = torch.autograd.grad(tl, lt)
    _close(tg, jg, RTOL_GRAD, "chunked loss gradient")


# ---------------------------------------------------------------- AdamW


def _random_tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("bias_corrected", [False, True])
def test_leaf_and_tree_update_match_jax(bias_corrected):
    """Random trees with rows masked: moments and parameters against the JAX
    functions, and the masked rows bit-identical."""
    rng = np.random.default_rng(0)
    shapes = {"a": (6, 5, 4), "b": (6, 7)}
    g, m, p = (_random_tree(rng, shapes) for _ in range(3))
    v = {k: np.abs(x) for k, x in _random_tree(rng, shapes).items()}
    tc, jtc = TrainConfig(weight_decay=0.1), JaxTrainConfig(weight_decay=0.1)
    lr, count = 3e-3, 3
    jbc = ((1.0 - jtc.beta1 ** jnp.float32(count), 1.0 - jtc.beta2 ** jnp.float32(count))
           if bias_corrected else None)
    c = torch.tensor(float(count))
    bc = ((1.0 - torch.pow(tc.beta1, c), 1.0 - torch.pow(tc.beta2, c))
          if bias_corrected else None)
    row_mask = lambda x, lib: lib.asarray(np.arange(x.shape[0]) >= 2, dtype=np.float32).reshape(
        (x.shape[0],) + (1,) * (x.ndim - 1))
    T = lambda tree: {k: torch.from_numpy(x.copy()) for k, x in tree.items()}
    J = lambda tree: {k: jnp.asarray(x) for k, x in tree.items()}
    jp2, jm2, jv2 = jax_adamw.tree_update(J(g), J(m), J(v), J(p), jtc, lr=lr,
                                          mask=lambda x: row_mask(x, jnp),
                                          bias_correction=jbc)
    tp2, tm2, tv2 = adamw.tree_update(T(g), T(m), T(v), T(p), tc, lr=lr,
                                      mask=lambda x: torch.from_numpy(row_mask(x, np)),
                                      bias_correction=bc)
    for name, got, want, before in (("p", tp2, jp2, p), ("m", tm2, jm2, m), ("v", tv2, jv2, v)):
        for k in shapes:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{name}[{k}]")
            np.testing.assert_array_equal(got[k].numpy()[:2], before[k][:2])
    # one leaf, no mask (the head's form)
    jm3, jv3, jp3 = jax_adamw.leaf_update(jnp.asarray(g["b"]), jnp.asarray(m["b"]),
                                          jnp.asarray(v["b"]), jnp.asarray(p["b"]), lr=lr,
                                          tc=jtc, bias_correction=jbc)
    tm3, tv3, tp3 = adamw.leaf_update(*(torch.from_numpy(x["b"]) for x in (g, m, v, p)),
                                      lr=lr, tc=tc, bias_correction=bc)
    for got, want in ((tm3, jm3), (tv3, jv3), (tp3, jp3)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_lr_warmup_and_opt_state_bytes_match_jax():
    tc, jtc = TrainConfig(warmup_steps=5), JaxTrainConfig(warmup_steps=5)
    for step in range(8):
        assert float(adamw.lr_at(tc, torch.tensor(step))) == \
            float(jax_adamw.lr_at(jtc, jnp.int32(step)))
    jcfg, tcfg = _configs("qwen2.5-3b")
    jp = _jax_params(jcfg)
    tp = bridge.params_from_jax(jp, tcfg, device="cpu")
    assert adamw.opt_state_bytes(adamw.init(training.full_trainable(tp, tcfg))) == \
        jax_adamw.opt_state_bytes(jax_adamw.init(jax_training.full_trainable(jp)))


# ---------------------------------------------------------------- plain backward versions


def _bf16_pair(x, dtype):
    """numpy f32 -> (jax array, torch tensor) holding the same values in ``dtype``."""
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy()).astype(dtype), t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
def test_adapter_plain_backward_matches_jax_vjp(act, dtype):
    rng = np.random.default_rng(1)
    T_, D, m = 40, 96, 16
    jh, h = _bf16_pair(rng.standard_normal((T_, D)).astype(np.float32), dtype)
    jwd, wd = _bf16_pair((0.2 * rng.standard_normal((D, m))).astype(np.float32), dtype)
    jwu, wu = _bf16_pair((0.2 * rng.standard_normal((m, D))).astype(np.float32), dtype)
    jg, g = _bf16_pair(rng.standard_normal((T_, D)).astype(np.float32), dtype)
    _, vjp = jax.vjp(lambda a, b, c: jax_ref.adapter_fused(a, b, c, activation=act), jh, jwd, jwu)
    want = vjp(jg)
    got = ref.adapter_fused_bwd(g, h, wd, wu, activation=act)
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for name, a, b in zip(("dh", "dw_down", "dw_up"), got, want):
        assert a.dtype == getattr(torch, dtype)
        _close(a, np.asarray(b.astype(jnp.float32)), rtol, name)
    # and against autograd of the plain forward, through ops on the CPU
    leaves = [t.clone().requires_grad_(True) for t in (h, wd, wu)]
    out = ops.adapter_fused(*leaves, activation=act)
    auto = torch.autograd.grad(out, leaves, g)
    for name, a, b in zip(("dh", "dw_down", "dw_up"), got, auto):
        _close(a, b.float().numpy(), rtol, f"{name} vs autograd")


def test_adapter_backward_rounds_dh_as_the_reference():
    """In bf16 the reference's dh is bf16(g + bf16(g_mid @ Wd^T)): the input
    term is rounded before it joins g. The plain backward matches jax.vjp
    bit for bit on at least 99.9% of the elements (the rest by at most one
    ulp of the term and one of dh, where the two frameworks' fp32 sums round
    the term differently); one rounding of g + term would match far fewer."""
    rng = np.random.default_rng(7)
    jh, h = _bf16_pair((4 * rng.standard_normal((256, 512))).astype(np.float32), "bfloat16")
    jwd, wd = _bf16_pair((0.2 * rng.standard_normal((512, 64))).astype(np.float32), "bfloat16")
    jwu, wu = _bf16_pair((0.2 * rng.standard_normal((64, 512))).astype(np.float32), "bfloat16")
    jg, g = _bf16_pair(rng.standard_normal((256, 512)).astype(np.float32), "bfloat16")
    _, vjp = jax.vjp(lambda a, b, c: jax_ref.adapter_fused(a, b, c), jh, jwd, jwu)
    want = np.asarray(vjp(jg)[0].astype(jnp.float32))
    dh, _, g_mid = ref.adapter_fused_bwd_terms(g, h, wd, wu)
    got = dh.float().numpy()
    term = (g_mid @ wd.float().t()).numpy()
    once = (g.float().numpy() + term).astype(np.float32)
    once = torch.from_numpy(once).to(torch.bfloat16).float().numpy()
    assert (got == want).mean() >= 0.999 and (once == want).mean() < 0.9
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * (np.abs(want) + np.abs(term)))


def _attention_vjp(q, k, v, g, causal, window):
    """jax.vjp of the reference's flash_attention ([N, S, hd], heads aligned):
    KV heads repeated over their query group; dk and dv summed back."""
    B_, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    heads_first = lambda x: x.transpose(0, 2, 1, 3).reshape(-1, x.shape[1], hd)

    def f(q, k, v):
        kr, vr = (jnp.repeat(x, G, axis=2) for x in (k, v))
        o = jax_ref.flash_attention(heads_first(q), heads_first(kr), heads_first(vr),
                                    causal=causal, window=window)
        return o.reshape(B_, H, Sq, hd).transpose(0, 2, 1, 3)

    _, vjp = jax.vjp(f, q, k, v)
    return vjp(g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,window,causal,hd", [
    pytest.param(24, 24, None, True, 64, id="24-24-None-True"),
    pytest.param(24, 24, 7, True, 64, id="24-24-7-True"),
    pytest.param(12, 24, None, True, 64, id="12-24-None-True"),
    pytest.param(20, 9, None, True, 64, id="20-9-None-True"),
    pytest.param(16, 16, 5, False, 64, id="16-16-5-False"),
    pytest.param(24, 24, None, True, 80, id="24-24-None-True-hd80")])
def test_attention_plain_backward_matches_jax_vjp(Sq, Sk, window, causal, hd, dtype):
    """GQA (4 query heads over 2 KV heads), a window, Sk > Sq, Sq > Sk (the
    first Sq - Sk rows see no key: lse -inf, gradient 0), not causal; head
    dim 64, and stablelm-3b's 80."""
    rng = np.random.default_rng(Sq * 100 + Sk)
    H, K = 4, 2
    jq, q = _bf16_pair(rng.standard_normal((2, Sq, H, hd)).astype(np.float32), dtype)
    jk, k = _bf16_pair(rng.standard_normal((2, Sk, K, hd)).astype(np.float32), dtype)
    jv, v = _bf16_pair(rng.standard_normal((2, Sk, K, hd)).astype(np.float32), dtype)
    jg, g = _bf16_pair(rng.standard_normal((2, Sq, H, hd)).astype(np.float32), dtype)
    want = _attention_vjp(jq, jk, jv, jg, causal, window)
    out, lse = ref.flash_attention(q, k, v, causal=causal, window=window, lse=True)
    assert lse.shape == (2, H, Sq) and lse.dtype == torch.float32
    got = ref.flash_attention_bwd(q, k, v, out, lse, g, causal=causal, window=window)
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -6
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == getattr(torch, dtype) and torch.isfinite(a).all()
        _close(a, np.asarray(b.astype(jnp.float32)), rtol, name)
    if Sq > Sk:
        assert torch.all(torch.isinf(lse[:, :, :Sq - Sk])) and torch.all(got[0][:, :Sq - Sk] == 0)
    # through ops on the CPU: the autograd Function against autograd of the plain forward
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=causal, window=window)
    auto = torch.autograd.grad(ref.flash_attention(*leaves, causal=causal, window=window),
                               leaves, g)
    via_ops = torch.autograd.grad(o, leaves, g)
    for name, a, b in zip(("dq", "dk", "dv"), via_ops, auto):
        _close(a, b.float().numpy(), rtol, f"{name} vs autograd")


# ---------------------------------------------------------------- data, schedule, bridge


def test_corpora_and_batches_equal_jax():
    for kind in ("lm", "qa"):
        want = jax_pipeline.make_client_datasets(3, vocab=97, n_per_client=11, seq=20, seed=4,
                                                 kind=kind)
        got = pipeline.make_client_datasets(3, vocab=97, n_per_client=11, seq=20, seed=4,
                                            kind=kind)
        for a, b in zip(got, want):
            assert (a.client_id, a.kind) == (b.client_id, b.kind)
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_array_equal(a.labels, b.labels)
        jb = jax_pipeline.Batcher(jax_pipeline.merged(want), 5, seed=2)
        tb = pipeline.Batcher(pipeline.merged(got), 5, seed=2)
        for _ in range(3):
            x, y = tb.next(), jb.next()
            assert set(x) == set(y)
            for key in x:
                assert isinstance(x[key], np.ndarray)
                np.testing.assert_array_equal(x[key], np.asarray(y[key]))
    t = pipeline.to_device({"tokens": np.arange(6, dtype=np.int32).reshape(2, 3)}, "cpu")
    assert t["tokens"].dtype == torch.int64


@pytest.mark.parametrize("arch", ARCHS + ["hymba-1.5b"])
def test_boundary_schedule_equals_jax(arch):
    for cut in (lambda c: c, lambda c: c.reduced()):
        jcfg, tcfg = cut(jax_get_config(arch)), cut(get_config(arch))
        for kw in (dict(), dict(initial_depth=2, interval=3), dict(interval=2, max_depth=3),
                   dict(depths=(1, 2, 36), interval=2), dict(depths=(1, 1, 2), interval=1)):
            js, ts = jax_unfreeze.UnfreezeSchedule(**kw), unfreeze.UnfreezeSchedule(**kw)
            for steps in (1, 7, 130):
                assert unfreeze.boundary_schedule(tcfg, ts, steps) == \
                    jax_unfreeze.boundary_schedule(jcfg, js, steps)
            for step in range(0, 90, 7):
                assert ts.depth_at(step, tcfg.n_layers) == js.depth_at(step, jcfg.n_layers)
        for depth in range(1, tcfg.n_layers + 2):
            assert unfreeze.depth_to_boundary(tcfg, depth) == \
                jax_unfreeze.depth_to_boundary(jcfg, depth)
    tc = TrainConfig(initial_unfreeze_depth=2, unfreeze_interval=5, max_unfreeze_depth=4)
    assert unfreeze.UnfreezeSchedule.from_train_config(tc) == unfreeze.UnfreezeSchedule(2, 5, 4)
    assert dataclasses.asdict(tc) == dataclasses.asdict(JaxTrainConfig(
        initial_unfreeze_depth=2, unfreeze_interval=5, max_unfreeze_depth=4))


def test_non_monotone_schedule_is_refused():
    with pytest.raises(ValueError, match="non-monotone"):
        unfreeze.UnfreezeSchedule(depths=(2, 1))
    for bad in (dict(interval=0), dict(initial_depth=0), dict(depths=())):
        with pytest.raises(ValueError):
            unfreeze.UnfreezeSchedule(**bad)


class _Shrinking:
    """A depth policy that shrinks (not an UnfreezeSchedule)."""

    def depth_at(self, step, n_blocks):
        return 2 if step < 3 else 1


def test_boundary_schedule_refuses_a_rising_boundary():
    _, tcfg = _configs("qwen2.5-3b")
    with pytest.raises(ValueError, match="boundary rises"):
        unfreeze.boundary_schedule(tcfg, _Shrinking(), 6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS + ["hymba-1.5b"])
def test_bridge_round_trip_is_exact(arch, dtype):
    """JAX -> port -> JAX, parameters and (dense, once per arch) AdamW state
    after a JAX step, so the moments are not zero."""
    jcfg, tcfg = _configs(arch, dtype)
    jp = _jax_params(jcfg)
    back = bridge.params_to_jax(bridge.params_from_jax(jp, tcfg, device="cpu"), tcfg,
                                bf16=jnp.bfloat16)
    flat_j, tree_j = jax.tree.flatten(jp)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8), b.view(np.uint8))
    if arch == "hymba-1.5b" or dtype != "float32":       # the moments are fp32 in both
        return
    jopt = jax_adamw.init(jax_training.full_trainable(jp))
    _, jopt, _ = jax_training.make_train_step(jcfg, JaxTrainConfig(), 1)(
        jp, jopt, {k: jnp.asarray(v) for k, v in _batch(tcfg).items()})
    jopt = jax.tree.map(np.asarray, jopt)
    back = bridge.opt_state_to_jax(bridge.opt_state_from_jax(jopt, tcfg, device="cpu"), tcfg)
    flat_j, tree_j = jax.tree.flatten(jopt)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_trainable_split_merge_and_write_back():
    """split_trainable / merge_trainable / slice_to_full / write_back keep
    the tree's structure, take the hot adapters and the head from the
    trainable tree, and share the frozen layers' tensors."""
    _, tcfg = _configs("qwen2.5-3b")
    tp = bridge.params_from_jax(_jax_params(_configs("qwen2.5-3b")[0]), tcfg, device="cpu")
    tr = training.split_trainable(tp, 1, tcfg)
    assert len(tr["adapters"]) == 1 and tr["adapters"][0] is tp["blocks"][1]["adapter"]
    new = {"adapters": [{k: t + 1 for k, t in a.items()} for a in tr["adapters"]],
           "head": {"w": tp["head"]["w"] * 2}}
    merged = training.merge_trainable(tp, new, 1, tcfg)
    assert merged["blocks"][0] is tp["blocks"][0]
    assert merged["blocks"][1]["adapter"] is new["adapters"][0]
    assert merged["blocks"][1]["attn"] is tp["blocks"][1]["attn"]
    assert merged["head"] is new["head"] and merged["embed"] is tp["embed"]
    full = training.slice_to_full(tp, new, 1, tcfg)
    assert full["adapters"][0] is tp["blocks"][0]["adapter"] and len(full["adapters"]) == 2
    back = training.write_back(tp, full)
    assert [b["adapter"] for b in back["blocks"]] == full["adapters"]
    assert back["head"] is new["head"]
    assert training.full_trainable(tp, tcfg)["adapters"] == [b["adapter"] for b in tp["blocks"]]


def test_train_cli_on_the_cpu(capsys):
    """One loss line per step with its boundary, the boundary walking down; a
    missing card is a refusal, not a fallback. (The ring mode's CLI is held in
    tests/test_torch_ring.py and tests/test_torch_executor.py.)"""
    from repro_torch.launch import train

    train.main(["--device", "cpu", "--reduced", "--steps", "3", "--unfreeze-interval", "2",
                "--batch-size", "2", "--seq-len", "16"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert [ln.split()[:4] for ln in lines] == [["step", "0", "boundary", "1"],
                                                ["step", "1", "boundary", "1"],
                                                ["step", "2", "boundary", "0"]]
    assert all(np.isfinite(float(ln.split()[5])) for ln in lines)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--reduced", "--steps", "1"])
