"""The port's kernels against the JAX package's, at reduced qwen2.5-3b shapes.

On the CPU the port's wrappers run their plain versions (``kernels/ref.py``);
these are held against the Pallas kernels in interpret mode and against
``repro.kernels.ref`` / ``repro.models.blocks._attend`` on the same inputs,
made with numpy from a seed. The CUDA kernels themselves are held against the
plain versions by ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` on the card.

Tolerances are the reference's own (tests/test_kernels.py): adapter 1e-5 in
f32 and 2e-2 in bf16 (one bf16 ulp of an O(1) residual stream), attention
1e-5 in f32 and 3e-2 in bf16 (the port keeps fp32 probabilities where the
Pallas kernel does; the jnp references round them to bf16 before PV).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import adapter_fused as jax_af  # noqa: E402
from repro.kernels import flash_attention as jax_fa  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro_torch.kernels import adapter_fused as torch_af  # noqa: E402
from repro_torch.kernels import flash_attention as torch_fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ATOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 3e-2)}   # (adapter, attention)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (bf16 rounded alike)."""
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return jnp.asarray(x).astype(getattr(jnp, dtype)), t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("T", [4, 256, 300])            # decode rows, one tile, ragged
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
def test_adapter_fused_matches_jax(T, dtype, act):
    D, m = 256, 16
    rng = np.random.default_rng(T)
    h_j, h_t = _pair(rng.standard_normal((T, D), np.float32), dtype)
    wd_j, wd_t = _pair(0.05 * rng.standard_normal((D, m), np.float32), dtype)
    wu_j, wu_t = _pair(0.05 * rng.standard_normal((m, D), np.float32), dtype)
    got = ops.adapter_fused(h_t, wd_t, wu_t, activation=act)
    assert got.dtype == h_t.dtype and got.shape == h_t.shape
    atol = ATOL[dtype][0]
    pallas = jax_af.adapter_fused(h_j, wd_j, wu_j, activation=act, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=atol)
    np.testing.assert_allclose(_np(got), _np(jax_ref.adapter_fused(h_j, wd_j, wu_j,
                                                                   activation=act)), atol=atol)


def test_adapter_fused_flattens_leading_dims_and_counts_no_cpu_launch():
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((2, 3, 64), np.float32))
    wd = torch.from_numpy(0.1 * rng.standard_normal((64, 16), np.float32))
    wu = torch.from_numpy(0.1 * rng.standard_normal((16, 64), np.float32))
    ops.reset_launches()
    out = ops.adapter_fused(h, wd, wu)
    want = ref.adapter_fused(h.reshape(-1, 64), wd, wu).reshape(h.shape)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert ops.LAUNCHES == {"adapter_fused": 0, "flash_attention": 0, "mamba_scan": 0,
                            "rwkv_scan": 0}


def _heads_first(x):
    """[B, S, H, hd] -> the Pallas kernel's [B*H, S, hd]."""
    B, S, H, hd = x.shape
    return jnp.transpose(x, (0, 2, 1, 3)).reshape(B * H, S, hd)


@pytest.mark.parametrize("S,window", [(128, None), (128, 32), (192, 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_matches_pallas(S, window, dtype):
    B, H, K, hd = 2, 4, 2, 64                      # GQA group 2, reduced qwen head_dim
    rng = np.random.default_rng(S + (window or 0))
    q_j, q_t = _pair(rng.standard_normal((B, S, H, hd), np.float32), dtype)
    k_j, k_t = _pair(rng.standard_normal((B, S, K, hd), np.float32), dtype)
    v_j, v_t = _pair(rng.standard_normal((B, S, K, hd), np.float32), dtype)
    got = ops.flash_attention(q_t, k_t, v_t, window=window)
    assert got.dtype == q_t.dtype and got.shape == q_t.shape
    # the Pallas kernel takes batch-major heads; KV head n // group within a row
    pallas = jax_fa.flash_attention(_heads_first(q_j), _heads_first(k_j), _heads_first(v_j),
                                    group=H // K, window=window, block_q=64, block_k=64,
                                    interpret=True)
    pallas = np.transpose(_np(pallas).reshape(B, H, S, hd), (0, 2, 1, 3))
    np.testing.assert_allclose(_np(got), pallas, atol=ATOL[dtype][1])


@pytest.mark.parametrize("Sq,Sk,window", [(100, 100, None), (100, 100, 48), (37, 100, None)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_ragged_matches_jax_ref(Sq, Sk, window, dtype):
    """Ragged lengths (any S, as left-padded prompts give) and end alignment."""
    H, K, hd = 4, 2, 64
    G = H // K
    rng = np.random.default_rng(Sq * Sk)
    q_j, q_t = _pair(rng.standard_normal((1, Sq, H, hd), np.float32), dtype)
    k_j, k_t = _pair(rng.standard_normal((1, Sk, K, hd), np.float32), dtype)
    v_j, v_t = _pair(rng.standard_normal((1, Sk, K, hd), np.float32), dtype)
    got = _np(ops.flash_attention(q_t, k_t, v_t, window=window))
    for n in range(H):
        want = jax_ref.flash_attention(q_j[:, :, n], k_j[:, :, n // G], v_j[:, :, n // G],
                                       window=window)
        np.testing.assert_allclose(got[0, :, n], _np(want[0]), atol=ATOL[dtype][1])


@pytest.mark.parametrize("S,window", [(160, None), (160, 128), (33, 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_is_prefill_attend(S, window, dtype):
    """The port's prefill attention equals the reference's ``_attend`` with
    q_pos = k_pos = 0..S-1, the call the reference's prefill makes."""
    B, H, K, hd = 2, 4, 2, 64
    rng = np.random.default_rng(S)
    q_j, q_t = _pair(rng.standard_normal((B, S, H, hd), np.float32), dtype)
    k_j, k_t = _pair(rng.standard_normal((B, S, K, hd), np.float32), dtype)
    v_j, v_t = _pair(rng.standard_normal((B, S, K, hd), np.float32), dtype)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    want = jax_blocks._attend(q_j, k_j, v_j, pos, pos, causal=True, window=window,
                              n_sink=0, q_chunk=S)
    got = ops.flash_attention(q_t, k_t, v_t, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype][1])


def test_fully_masked_rows_give_zero():
    """Sq > Sk end-aligned: the first Sq - Sk queries see no key."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 64), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 4, 1, 64), np.float32))
    out = ops.flash_attention(q, k, k)
    assert torch.all(out[:, :4] == 0) and torch.all(out[:, 4:].abs().sum(-1) > 0)


def test_kernel_launchers_take_cuda_tensors_only():
    """No silent fallback: the launchers refuse a CPU tensor instead of computing."""
    h = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        torch_af.adapter_fused(h, torch.zeros(64, 16), torch.zeros(16, 64))
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        torch_fa.flash_attention(q, q[:, :, :1], q[:, :, :1])
    with pytest.raises(ValueError, match="impl"):
        ops.adapter_fused(h, torch.zeros(64, 16), torch.zeros(16, 64), impl="jnp")


@pytest.mark.parametrize("D,dtype,staged", [(2048, torch.bfloat16, True),
                                            (4096, torch.bfloat16, True),
                                            (4608, torch.bfloat16, True),
                                            (3312, torch.float32, True),
                                            (4096, torch.float32, False),
                                            (4608, torch.float32, False),
                                            (5120, torch.float32, False)])
@pytest.mark.parametrize("T", [4, 2048])
def test_adapter_fused_launcher_takes_every_model_width(D, dtype, staged, T):
    """The [16, D] h tile is staged in shared memory where it fits; wider f32
    (rwkv6-7b at 4096, starcoder2-7b at 4608, llama4 at 5120) reads h rows
    from device memory instead, so the shape check no longer refuses it. The
    kernel itself runs only on the card (tests/test_torch_gpu.py)."""
    meta = lambda *shape: torch.empty(shape, dtype=dtype, device="meta")
    stage, smem = torch_af.check(meta(T, D), meta(D, 64), meta(64, D), "gelu")
    assert stage == staged and smem <= torch_af.SMEM_LIMIT
    assert smem == 4 * (256 * 16 + 16 * 64) + staged * dtype.itemsize * 16 * D
    with pytest.raises(ValueError, match="CUDA"):
        torch_af.adapter_fused(torch.zeros(T, D, dtype=dtype), torch.zeros(D, 64, dtype=dtype),
                               torch.zeros(64, D, dtype=dtype))


@pytest.mark.parametrize("m", [16, 48, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-7b", "hymba-1.5b"])
def test_adapter_fused_launcher_plans_decode_clusters(arch, dtype, m):
    """Up to SMALL_T rows (decode) the launcher picks one cluster of CLUSTER
    blocks, whose shared-memory layout fits at every model width of the port
    and gives each region the room the kernel uses; above it, the tile path.
    Pure Python: the kernels run only on the card."""
    from repro_torch.configs import get_config

    D = get_config(arch).d_model
    assert torch_af.CLUSTER == 16 and torch_af.SMALL_T == 16
    size, threads = dtype.itemsize, torch_af.THREADS
    vec = 16 // size
    for T in range(1, torch_af.SMALL_T + 1):
        assert torch_af.cluster_size(T, D, m, dtype) == torch_af.CLUSTER
        p = torch_af.cluster_plan(T, D, m, dtype)
        nt, dc = p.nt, p.dc
        assert T <= nt < 2 * T and nt & (nt - 1) == 0          # least power of two >= T
        # ceil(D / 16) columns per block, rounded up to 16 bytes
        assert dc % vec == 0 and dc * torch_af.CLUSTER >= D > (dc - vec) * torch_af.CLUSTER
        weights = size * dc * m
        regions = [(0, 4 * threads * nt), (p.part, 4 * nt * m), (p.mid, 4 * m * nt),
                   (p.hs, 4 * dc * nt), (p.wd, weights)]
        if p.wu != p.wd:
            regions.append((p.wu, weights))
        else:   # W_up takes W_down's buffer only where both do not fit
            assert p.wd + 2 * weights > torch_af.SMEM_LIMIT
        regions.sort()
        for (start, n), (nxt, _) in zip(regions, regions[1:]):
            assert start + n <= nxt
        assert regions[-1][0] + regions[-1][1] == p.smem <= torch_af.SMEM_LIMIT
        assert p.wd % 16 == 0 and p.wu % 16 == 0
    for T in (torch_af.SMALL_T + 1, 300, 2048):
        assert torch_af.cluster_size(T, D, m, dtype) == 0
        assert torch_af.cluster_plan(T, D, m, dtype) is None
    with pytest.raises(ValueError, match="CUDA"):
        torch_af.adapter_fused(torch.zeros(4, D, dtype=dtype), torch.zeros(D, m, dtype=dtype),
                               torch.zeros(m, D, dtype=dtype))


def test_adapter_fused_decode_path_refuses_what_does_not_fit():
    """A width whose share of the weights does not fit even with W_up in
    W_down's buffer goes to the tile path."""
    assert torch_af.cluster_size(4, 8192, 128, torch.float32) == 0
    assert torch_af.cluster_size(4, 8192, 64, torch.float32) == torch_af.CLUSTER
    assert torch_af.cluster_size(4, 2048, 512, torch.bfloat16) == 0


@pytest.mark.parametrize("hd,dtype,kernel", [(64, torch.bfloat16, "tensor_cores"),
                                             (128, torch.bfloat16, "tensor_cores"),
                                             (64, torch.float32, "scalar"),
                                             (128, torch.float32, "scalar")])
def test_flash_attention_launcher_picks_kernel_by_dtype(hd, dtype, kernel):
    """bf16 runs the tensor-core kernel and f32 the scalar one, also for q as a
    strided view of a fused [B, S, 3, H, hd] tensor. Pure Python: no card."""
    qkv = torch.empty(2, 70, 3, 8, hd, dtype=dtype, device="meta")
    q, k, v = qkv[:, :, 0], qkv[:, :, 1, :2], qkv[:, :, 2, :2]
    assert torch_fa.kernel_for(q, k, v) == kernel


@pytest.mark.parametrize("case", ["hd80", "mixed_dtypes", "gqa_mismatch", "last_stride"])
def test_flash_attention_launcher_refuses_what_no_kernel_takes(case):
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    q, k = meta(1, 64, 8, 128), meta(1, 64, 2, 128)
    v = k
    if case == "hd80":
        q, k, v = meta(1, 64, 8, 80), meta(1, 64, 2, 80), meta(1, 64, 2, 80)
    elif case == "mixed_dtypes":
        v = meta(1, 64, 2, 128, dtype=torch.float32)
    elif case == "gqa_mismatch":
        k = v = meta(1, 64, 3, 128)
    else:
        q = meta(1, 64, 128, 8).transpose(2, 3)
    with pytest.raises(ValueError):
        torch_fa.kernel_for(q, k, v)
