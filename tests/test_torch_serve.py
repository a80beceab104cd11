"""The port's serving path against the JAX package, at reduced qwen2.5-3b.

Reduced qwen2.5-3b: d 256, 4 query heads over 2 KV heads (head_dim 64), a
sliding window of 128, vocab 512, 2 layers, adapter bottleneck 16. Weights are
made by the JAX package and carried across with ``repro_torch.bridge``; every
adapter has a non-zero ``W_up`` (an identity adapter would hide a wrong one).
On the CPU the port runs the plain versions of its kernels.

Tolerances: bf16 5e-2 (bf16 rounding at different places in the two
frameworks, over two layers); f32 1e-3 (both KV caches are bf16, and a K on a
bf16 rounding boundary moves a logit by about 1e-3). The bf16 caches differ
by one bf16 ulp where the two frameworks round a K or V on either side of a
boundary (relative 2**-7); in the bf16 model, the second layer's K and V also
inherit the first layer's bf16 residual differences, so they are held to one
bf16 ulp of the tensor's largest entry.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api.tenants import AdapterStore as JaxAdapterStore  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import params as jax_prm  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api.tenants import AdapterStore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ATOL = {"bfloat16": 5e-2, "float32": 1e-3}


def _configs(dtype: str):
    """The same reduced qwen2.5-3b in both packages, with non-zero W_up."""
    out = []
    for get in (jax_get_config, get_config):
        cfg = get("qwen2.5-3b").reduced(dtype=dtype)
        out.append(dataclasses.replace(
            cfg, adapter=dataclasses.replace(cfg.adapter, zero_init_up=False)))
    return out


def _jax_params(cfg, seed=0):
    return jax_prm.materialize(jax_prm.param_defs(cfg), jax.random.key(seed), cfg.dtype)


def _port_params(jparams, cfg):
    return bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_config_copy_matches_reference():
    for name_cfg in (lambda g: g("qwen2.5-3b"), lambda g: g("qwen2.5-3b").reduced()):
        jc, tc = name_cfg(jax_get_config), name_cfg(get_config)
        j, t = dataclasses.asdict(jc), dataclasses.asdict(tc)
        assert j == t
        assert jc.param_count() == tc.param_count()
        assert jc.padded_vocab == tc.padded_vocab


def test_bridge_carries_jax_weights_exactly():
    jcfg, tcfg = _configs("bfloat16")
    jparams = _jax_params(jcfg)
    port = _port_params(jparams, tcfg)
    assert len(port["blocks"]) == tcfg.n_layers
    ref_shapes = prm.materialize(tcfg, seed=0, device="cpu")
    for layer in range(tcfg.n_layers):
        for sub in ("ln1", "attn", "ln2", "ffn", "adapter"):
            for leaf, t in port["blocks"][layer][sub].items():
                want = np.asarray(jparams["blocks"][0][sub][leaf][layer, 0], np.float32)
                np.testing.assert_array_equal(_np(t), want)
                assert t.dtype == ref_shapes["blocks"][layer][sub][leaf].dtype
                assert t.shape == ref_shapes["blocks"][layer][sub][leaf].shape
    np.testing.assert_array_equal(_np(port["embed"]["tok"]),
                                  np.asarray(jparams["embed"]["tok"], np.float32))
    assert port["final_norm"]["scale"].dtype == torch.float32


def test_materialize_honours_zero_init_up():
    cfg = get_config("qwen2.5-3b").reduced()
    p = prm.materialize(cfg, seed=0, device="cpu")
    assert all(torch.all(b["adapter"]["w_up"] == 0) for b in p["blocks"])
    _, cfg_nz = _configs("bfloat16")
    p = prm.materialize(cfg_nz, seed=0, device="cpu")
    assert all(torch.any(b["adapter"]["w_up"] != 0) for b in p["blocks"])
    q = prm.materialize(cfg_nz, seed=0, device="cpu")
    assert torch.equal(p["head"]["w"], q["head"]["w"])        # seeded


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prefill_and_decode_match_reference(dtype):
    """A 160-token prompt over a window of 128: prefill fills the ring buffer
    through the gather, and decode writes through ``write_slot``."""
    jcfg, tcfg = _configs(dtype)
    jparams = _jax_params(jcfg)
    port = _port_params(jparams, tcfg)
    B, S, seq_len = 2, 160, 168
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    atol = ATOL[dtype]

    jl, jc = jax_tfm.prefill(jparams, jnp.asarray(toks), jcfg, seq_len=seq_len, impl="jnp")
    tl, tc = tfm.prefill(port, torch.from_numpy(toks).long(), tcfg, seq_len=seq_len)
    assert tl.dtype == getattr(torch, dtype) and tl.shape == (B, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=atol)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert tc["pos"].shape[1] == 128 and tc["layers"][0]["k"].dtype == torch.bfloat16
    for i in range(tcfg.n_layers):
        for name in ("k", "v"):
            want = _np(jc["layers"][0][name][i, 0])
            # f32 model: one bf16 ulp of each entry; bf16 model: one bf16 ulp
            # of the largest entry (the residual stream differs by bf16 ulps)
            cache_atol = 1e-3 if dtype == "float32" else 2.0 ** -7 * np.abs(want).max()
            np.testing.assert_allclose(_np(tc["layers"][i][name]), want,
                                       rtol=2.0 ** -7, atol=cache_atol)

    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    for _ in range(3):
        jl, jc = jax_tfm.decode_step(jparams, jtok, jc, jcfg, impl="jnp")
        tl, tc = tfm.decode_step(port, torch.tensor(np.asarray(jtok)).long(), tc, tcfg)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=atol)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        np.testing.assert_array_equal(tc["next"].numpy(), np.asarray(jc["next"]))
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]


def test_forward_last_logits_equal_prefill():
    _, tcfg = _configs("float32")
    port = prm.materialize(tcfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 40)))
    full = tfm.forward(port, toks, tcfg)
    last, _ = tfm.prefill(port, toks, tcfg, seq_len=48)
    torch.testing.assert_close(full[:, -1], last, rtol=0, atol=1e-5)


def _requests(cls, vocab, tenants=(None,)):
    rng = np.random.default_rng(7)
    return [cls(i, rng.integers(0, vocab, size=int(rng.integers(5, 24))).astype(np.int32), 5,
                tenant=tenants[i % len(tenants)])
            for i in range(4)]


def _jax_bundle_store(root, jcfg, jparams):
    """A tenant bundle with random adapters and head, written by the JAX AdapterStore."""
    rng = np.random.default_rng(11)
    rnd = lambda x: jnp.asarray(0.05 * rng.standard_normal(x.shape, np.float32)
                                ).astype(x.dtype)
    bundle = {"adapter": jax.tree.map(rnd, jparams["blocks"][0]["adapter"]),
              "head": jax.tree.map(rnd, jparams["head"])}
    JaxAdapterStore(str(root)).put("t1", bundle, step=3)
    return bundle


def test_batch_server_and_registry_match_reference(tmp_path):
    """Identical greedy tokens from both servers (f32 config), for the trunk
    and for a tenant whose bundle the JAX AdapterStore wrote."""
    jcfg, tcfg = _configs("float32")
    jparams = _jax_params(jcfg)
    port = _port_params(jparams, tcfg)
    bundle = _jax_bundle_store(tmp_path, jcfg, jparams)

    jreg = jax_serve.AdapterRegistry(jparams, JaxAdapterStore(str(tmp_path)))
    treg = serve.AdapterRegistry(port, AdapterStore(str(tmp_path)))
    assert treg.refresh() == ["t1"] and treg.refresh() == []
    grafted = treg.params_for("t1")
    for layer in range(tcfg.n_layers):
        np.testing.assert_array_equal(
            _np(grafted["blocks"][layer]["adapter"]["w_up"]),
            np.asarray(bundle["adapter"]["w_up"][layer, 0], np.float32))
    np.testing.assert_array_equal(_np(grafted["head"]["w"]), np.asarray(bundle["head"]["w"]))
    assert grafted["blocks"][0]["ffn"] is port["blocks"][0]["ffn"]    # shared trunk

    tenants = (None, "t1")
    jsrv = jax_serve.BatchServer(jcfg, jparams, slots=2, horizon=40, impl="jnp",
                                 registry=jreg)
    tsrv = serve.BatchServer(tcfg, port, slots=2, horizon=40, registry=treg, device="cpu")
    want = jsrv.run(_requests(jax_serve.Request, jcfg.vocab_size, tenants), log=lambda *a: None)
    got = tsrv.run(_requests(serve.Request, tcfg.vocab_size, tenants), log=lambda *a: None)
    assert got == want
    assert [b["rows"] for b in tsrv.batches] == [2, 2]
    assert all(len(v) == 5 for v in got.values())


def test_entry_points_need_a_card_unless_given_cpu():
    cfg = get_config("qwen2.5-3b").reduced()
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prm.materialize(cfg, seed=0)
    params = prm.materialize(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.BatchServer(cfg, params, slots=2, horizon=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1"])


def test_cli_serves_on_cpu(capsys):
    serve.main(["--device", "cpu", "--requests", "3", "--slots", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "on cpu" in out
