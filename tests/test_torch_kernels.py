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
    assert ops.LAUNCHES == {"adapter_fused": 0, "adapter_fused_bwd": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0, "mamba_scan": 0, "mamba_scan_bwd": 0,
                            "rwkv_scan": 0, "rwkv_scan_bwd": 0}


def _heads_first(x):
    """[B, S, H, hd] -> the Pallas kernel's [B*H, S, hd]."""
    B, S, H, hd = x.shape
    return jnp.transpose(x, (0, 2, 1, 3)).reshape(B * H, S, hd)


@pytest.mark.parametrize("S,window,hd", [
    pytest.param(128, None, 64, id="128-None"), pytest.param(128, 32, 64, id="128-32"),
    pytest.param(192, 128, 64, id="192-128"), pytest.param(128, None, 80, id="128-None-hd80")])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_matches_pallas(S, window, hd, dtype):
    """GQA group 2 at the reduced qwen head_dim 64, and at stablelm-3b's 80."""
    B, H, K = 2, 4, 2
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
    """Every width takes a kernel. bf16 prefill stages each block's slice of the
    h tile in shared memory (the tile path); f32 stages the [16, D] tile where
    it fits and wider f32 (rwkv6-7b at 4096, starcoder2-7b at 4608, llama4 at
    5120) reads h rows from device memory, so the shape check refuses none.
    The kernels themselves run only on the card (tests/test_torch_gpu.py)."""
    meta = lambda *shape: torch.empty(shape, dtype=dtype, device="meta")
    kernel, p = torch_af.check(meta(T, D), meta(D, 64), meta(64, D), "gelu")
    if T <= torch_af.SMALL_T:
        assert kernel == "cluster" and p.smem <= torch_af.SMEM_LIMIT
    elif dtype == torch.bfloat16:
        assert kernel == "tile" and staged and p.smem <= torch_af.SMEM_LIMIT
        assert p.wd - p.hs >= 2 * torch_af.TILE_ROWS * p.dc   # the staged slice of h
    else:
        assert kernel == ("staged" if staged else "rows") and p <= torch_af.SMEM_LIMIT
    stage, smem = torch_af.plan(D, 64, dtype)          # the 16-row CUDA-core kernel
    assert stage == (staged and dtype == torch.float32) and smem <= torch_af.SMEM_LIMIT
    assert smem == 4 * (256 * 16 + 16 * 64) + stage * dtype.itemsize * 16 * D
    with pytest.raises(ValueError, match="CUDA"):
        torch_af.adapter_fused(torch.zeros(T, D, dtype=dtype), torch.zeros(D, 64, dtype=dtype),
                               torch.zeros(64, D, dtype=dtype))


SERVED_T = (17, 33, 808, 1320, 1780, 2048, 2292)    # ragged, and the served prefills


@pytest.mark.parametrize("D", [1600, 2048, 4096, 4608])
@pytest.mark.parametrize("m", [16, 48, 64, 128])
def test_adapter_fused_tile_plan_at_served_shapes(m, D):
    """The bf16 prefill path's plan at every served T and width: it fits in
    shared memory, its cluster is one the card allows (at most 16 blocks,
    above 8 non-portable), every row of h belongs to one tile and every
    column to one block of the cluster, every row of the intermediate is
    summed by one block, and the regions of the layout do not overlap.
    Pure Python: the kernels run only on the card."""
    for T in SERVED_T:
        kernel, p = torch_af.route(T, D, m, torch.bfloat16)
        assert kernel == "tile" and p == torch_af.tile_plan(T, D, m)
        bt = torch_af.TILE_ROWS
        assert bt == 64 and p.cluster in (1, 2, 4, 8, 16)
        assert p.smem <= torch_af.SMEM_LIMIT
        assert p.mp % 16 == 0 and m <= p.mp < m + 16
        tiles = -(-T // bt)
        assert (tiles - 1) * bt < T <= tiles * bt                   # rows: one tile each
        # ceil(D / cluster) columns per block, rounded up to 64 (so blocks at the
        # end of a cluster may own fewer columns, or none), at most TILE_CHUNKS x 64
        assert p.dc == 64 * -(-(-(-D // p.cluster)) // 64) and p.cluster * p.dc >= D
        assert p.dc <= 64 * torch_af.TILE_CHUNKS
        owner = [d // p.dc for d in range(D)]                        # columns: one block each
        assert owner[0] == 0 and owner[-1] < p.cluster and owner == sorted(owner)
        summed = sorted(t for r in range(p.cluster) for t in range(r, bt, p.cluster))
        assert summed == list(range(bt)) and bt % p.cluster == 0      # intermediate rows
        sizes = {"hs": 2 * bt * p.dc, "wd": 2 * 64 * -(-m // 64) * p.dc, "wu": 2 * p.mp * p.dc,
                 "part": 4 * bt * (p.mp + 8), "hi": 2 * bt * (p.mp + 8),
                 "lo": 2 * bt * (p.mp + 8), "bar": 16 * -(-8 * (torch_af.TILE_CHUNKS + 1) // 16)}
        for k in ("hs", "wd", "wu"):                   # the TMA's swizzled tiles
            assert getattr(p, k) % 1024 == 0
        # W_down's buffer is free after the first cluster barrier and W_up may
        # take it; the plan lets the most blocks share an SM, loading W_up
        # with h where that costs none
        apart = 1024 + sum(sizes.values())
        share = apart - sizes["wd"] - sizes["wu"] + max(sizes["wd"], sizes["wu"])
        fits = [n for n in (apart, share) if n <= torch_af.SMEM_LIMIT]
        most = max(torch_af.blocks_per_sm(n) for n in fits)
        assert p.smem == (apart if apart in fits and torch_af.blocks_per_sm(apart) == most
                          else share)
        own = dict(sizes)                       # the regions with room of their own
        if p.wu == p.wd:
            own["wd"] = max(own["wd"], own.pop("wu"))
        regions = sorted((getattr(p, k), n) for k, n in own.items())
        assert regions[0][0] == 0
        for (start, n), (nxt, _) in zip(regions, regions[1:]):
            assert start % 16 == 0 and n % 16 == 0 and start + n <= nxt
        assert 1024 + regions[-1][0] + regions[-1][1] == p.smem      # 1024: for alignment
        # the plan that timed fastest: clusters of 8 where two blocks share an
        # SM, else 16; each weight byte is read once per tile of 64 rows
        two = [c for c in (8, 16) if torch_af.tile_layout(D, m, c)
               and torch_af.blocks_per_sm(torch_af.tile_layout(D, m, c).smem) == 2]
        assert p.cluster == (two[0] if two else 16)


@pytest.mark.parametrize("T,D,m,dtype,kernel", [
    (4, 2048, 64, torch.bfloat16, "cluster"), (16, 4096, 64, torch.bfloat16, "cluster"),
    (17, 2048, 64, torch.bfloat16, "tile"), (2048, 5120, 64, torch.bfloat16, "tile"),
    (300, 1000, 50, torch.bfloat16, "rows"), (77, 200, 256, torch.bfloat16, "tile"),
    (40, 8192, 256, torch.bfloat16, "rows"), (2048, 2048, 64, torch.float32, "staged"),
    (2048, 4096, 64, torch.float32, "rows"), (17, 3312, 16, torch.float32, "staged"),
    (300, 1001, 64, torch.bfloat16, "rows"), (300, 1000, 64, torch.bfloat16, "tile")])
def test_adapter_fused_route_by_shape(T, D, m, dtype, kernel):
    """Which kernel a shape takes, by shape alone: the decode cluster up to 16
    rows; above, bf16 takes the tile path wherever D and m are multiples of 8
    (its TMA copies move 16-byte rows) and a plan fits (no served model's
    shape misses it; m = 256 at D 8192 does), else the 16-row CUDA-core
    kernel reading rows; f32 the 16-row kernel, staged where its [16, D] tile
    fits."""
    assert torch_af.route(T, D, m, dtype).kernel == kernel


@pytest.mark.parametrize("which", ["h", "w_down", "w_up"])
def test_adapter_fused_check_sends_unaligned_data_to_rows(which):
    """The tile path's TMA takes 16-byte aligned rows only: a contiguous view
    at an odd offset of a larger tensor goes to the 16-row kernel, by
    ``check``, which sees the data (``route`` sees the shape alone)."""
    T, D, m = 300, 1024, 64
    shapes = {"h": (T, D), "w_down": (D, m), "w_up": (m, D)}
    ts = {k: torch.zeros(s, dtype=torch.bfloat16) for k, s in shapes.items()}
    assert torch_af.check(ts["h"], ts["w_down"], ts["w_up"], "gelu").kernel == "tile"
    n = shapes[which][0] * shapes[which][1]
    ts[which] = torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(shapes[which])
    assert ts[which].is_contiguous() and ts[which].data_ptr() % 16
    kernel, smem = torch_af.check(ts["h"], ts["w_down"], ts["w_up"], "gelu")
    assert (kernel, smem) == ("rows", torch_af.plan(D, m, torch.bfloat16)[1])


def test_adapter_fused_tile_plan_misses_only_what_does_not_fit():
    """The bf16 tile path refuses a shape only where no cluster size fits, or
    D or m is not a multiple of 8, and the 16-row kernel takes it: at m 64
    and 128 every width of the configs (up to 5120) fits, at m 256 every
    width up to 2048."""
    assert torch_af.tile_plan(2048, 2044, 64) is None and torch_af.tile_plan(2048, 2048, 60) is None
    for m, least in ((64, 6144), (128, 6144), (256, 2048)):
        widest = max(D for D in range(32, 16385, 32) if torch_af.tile_plan(2048, D, m))
        assert widest >= least
        assert all(torch_af.tile_plan(2048, D, m) for D in range(32, widest + 1, 32))
        assert torch_af.route(2048, widest + 32, m, torch.bfloat16).kernel == "rows"
        for cluster in torch_af.TILE_CLUSTERS:
            assert torch_af.tile_layout(widest + 32, m, cluster) is None


@pytest.mark.parametrize("name,entries", [
    pytest.param("adapter_fused", {"adapter_fused_launch", "adapter_fused_cluster_launch",
                                   "adapter_fused_cluster_occupancy", "adapter_fused_tile_launch",
                                   "adapter_fused_tile_occupancy", "adapter_fused_bwd_launch",
                                   "adapter_fused_bwd_tile_launch",
                                   "adapter_fused_bwd_tile_occupancy"},
                 id="adapter_fused"),
    pytest.param("flash_attention", {"flash_attention_launch", "flash_attention_tc_launch",
                                     "flash_attention_bwd_launch", "flash_attention_bwd_tile"},
                 id="flash_attention"),
    pytest.param("rwkv_scan", {"rwkv_scan_launch", "rwkv_scan_bwd_launch"}, id="rwkv_scan"),
    pytest.param("mamba_scan", {"mamba_scan_launch", "mamba_scan_bwd_launch",
                                "mamba_scan_chunk", "mamba_scan_bwd_blocks"},
                 id="mamba_scan")])
def test_kernel_sources_export_what_the_launchers_bind(name, entries):
    """Every C entry a launcher binds with ctypes is defined in its CUDA
    source (a missing one fails only at load time, on the card); the
    backward entries among them, and the sizes the launchers take from the
    library (the bf16 backward's tile, the scan's checkpoint spacing and
    its backward's blocks)."""
    import re
    from pathlib import Path

    root = Path(torch_af.__file__).parent
    text = (root / f"{name}.py").read_text()
    bound = set(re.findall(rf"\b({name}\w*_(?:launch|occupancy|bwd_tile|chunk|bwd_blocks))\b",
                           text))
    src = (root / "csrc" / f"{name}.cu").read_text()
    exported = src[src.index('extern "C" {'):]
    assert bound == entries
    assert all(re.search(rf"\b{fn}\(", exported) for fn in bound)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round an fp32 tensor to bf16 (to nearest even) and back to fp32."""
    return x.to(torch.bfloat16).float()


def _tile_path_emulated(h, wd, wu, act, plan, parts=2):
    """The bf16 tile path's arithmetic on the CPU: each of the plan's blocks
    sums its columns' share of h @ W_down in fp32 (bf16 products are exact),
    the cluster adds the partials in rank order, the fp32 intermediate goes
    through the activation and is split into hi = bf16(mid) and
    lo = bf16(mid - hi), each block sums hi @ W_up + lo @ W_up over its own
    columns in fp32, the up term is rounded to bf16 and added to h. With
    ``parts=1`` only hi is used (one bf16 product). Returns (out, up)."""
    hf, wdf, wuf = h.float(), wd.float(), wu.float()
    D = h.shape[1]
    cols = [slice(r * plan.dc, min(D, (r + 1) * plan.dc)) for r in range(plan.cluster)]
    part = [hf[:, c] @ wdf[c] for c in cols if c.start < D]
    total = part[0]
    for p in part[1:]:
        total = total + p
    mid = ref.act(act, total)
    hi = _bf16(mid)
    lo = _bf16(mid - hi)
    up = torch.cat([hi @ wuf[:, c] + (lo @ wuf[:, c] if parts == 2 else 0.0)
                    for c in cols if c.start < D], dim=1)
    return (hf + _bf16(up)).to(torch.bfloat16), up, mid


@pytest.mark.parametrize("T,D,m", [(33, 256, 16), (300, 200, 48), (130, 1000, 64)])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
def test_adapter_fused_tile_split_matches_jax(T, D, m, act):
    """The hi/lo split of the bf16 tile path's up-projection, emulated on the
    CPU, against the JAX reference (``repro.kernels.ref``) and the Pallas
    kernel in interpret mode: within the kernel's tolerance, atol 2e-2 plus
    one bf16 ulp (rtol 2**-7; its fp32 sums run in another order, which can
    move h + up across a rounding boundary). Its up term stays within 2**-15
    of |mid| @ |W_up| of the exact one; one bf16 product (hi alone) does not."""
    rng = np.random.default_rng(T + D + m)
    h_j, h_t = _pair(rng.standard_normal((T, D), np.float32), "bfloat16")
    wd_j, wd_t = _pair(0.05 * rng.standard_normal((D, m), np.float32), "bfloat16")
    wu_j, wu_t = _pair(0.05 * rng.standard_normal((m, D), np.float32), "bfloat16")
    plan = torch_af.tile_plan(T, D, m)
    got, up, mid = _tile_path_emulated(h_t, wd_t, wu_t, act, plan)
    tol = dict(atol=ATOL["bfloat16"][0], rtol=2.0 ** -7)
    np.testing.assert_allclose(_np(got), _np(jax_ref.adapter_fused(h_j, wd_j, wu_j,
                                                                   activation=act)), **tol)
    pallas = jax_af.adapter_fused(h_j, wd_j, wu_j, activation=act, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)
    exact = mid.double() @ wu_t.double()
    scale = mid.double().abs() @ wu_t.double().abs()
    assert ((up.double() - exact).abs() <= 2.0 ** -15 * scale).all()
    _, up1, _ = _tile_path_emulated(h_t, wd_t, wu_t, act, plan, parts=1)
    assert ((up1.double() - exact).abs() > 2.0 ** -15 * scale).any()


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
                                             (128, torch.float32, "scalar"),
                                             (80, torch.bfloat16, "tensor_cores"),
                                             (80, torch.float32, "scalar")])
def test_flash_attention_launcher_picks_kernel_by_dtype(hd, dtype, kernel):
    """bf16 runs the tensor-core kernel and f32 the scalar one, also for q as a
    strided view of a fused [B, S, 3, H, hd] tensor. Pure Python: no card."""
    qkv = torch.empty(2, 70, 3, 8, hd, dtype=dtype, device="meta")
    q, k, v = qkv[:, :, 0], qkv[:, :, 1, :2], qkv[:, :, 2, :2]
    assert torch_fa.kernel_for(q, k, v) == kernel


@pytest.mark.parametrize("case", ["hd96", "mixed_dtypes", "gqa_mismatch", "last_stride"])
def test_flash_attention_launcher_refuses_what_no_kernel_takes(case):
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    q, k = meta(1, 64, 8, 128), meta(1, 64, 2, 128)
    v = k
    if case == "hd96":
        q, k, v = meta(1, 64, 8, 96), meta(1, 64, 2, 96), meta(1, 64, 2, 96)
    elif case == "mixed_dtypes":
        v = meta(1, 64, 2, 128, dtype=torch.float32)
    elif case == "gqa_mismatch":
        k = v = meta(1, 64, 3, 128)
    else:
        q = meta(1, 64, 128, 8).transpose(2, 3)
    with pytest.raises(ValueError):
        torch_fa.kernel_for(q, k, v)


@pytest.mark.parametrize("case", ["cpu", "hd96", "mixed_dtypes", "lse_dtype", "dout_shape"])
def test_flash_attention_bwd_launcher_refuses_what_no_kernel_takes(case):
    """The backward launcher checks shapes and dtypes on any device, then
    refuses anything but CUDA tensors: no fallback."""
    dev = "cpu" if case == "cpu" else "meta"
    t = lambda *s, dtype=torch.bfloat16: torch.zeros(s, dtype=dtype, device=dev)
    q, k, v = t(1, 64, 8, 128), t(1, 64, 2, 128), t(1, 64, 2, 128)
    out, dout, lse = t(1, 64, 8, 128), t(1, 64, 8, 128), t(1, 8, 64, dtype=torch.float32)
    if case == "hd96":
        q, out, dout = t(1, 64, 8, 96), t(1, 64, 8, 96), t(1, 64, 8, 96)
        k = v = t(1, 64, 2, 96)
    elif case == "mixed_dtypes":
        dout = t(1, 64, 8, 128, dtype=torch.float32)
    elif case == "lse_dtype":
        lse = t(1, 8, 64)
    elif case == "dout_shape":
        dout = t(1, 63, 8, 128)
    with pytest.raises(ValueError, match="CUDA" if case == "cpu" else None):
        torch_fa.flash_attention_bwd(q, k, v, out, lse, dout)


@pytest.mark.parametrize("B,Sk,K,group,parts", [(4, 512, 2, 8, 8),     # qwen2.5-3b training
                                                (4, 512, 32, 1, 1),    # stablelm-3b (MHA)
                                                (4, 512, 5, 5, 5),     # hymba-1.5b heads
                                                (16, 2048, 2, 8, 1),   # blocks enough unsplit
                                                (3, 4096, 2, 8, 1),
                                                (4, 2048, 2, 8, 2),
                                                (2, 2112, 2, 8, 2),    # 2 blocks per SM exactly
                                                (4, 1024, 2, 8, 4)])
def test_flash_attention_bwd_parts_fill_the_card(B, Sk, K, group, parts):
    """The bf16 dK/dV blocks split each GQA group into the fewest parts that
    start two blocks per SM of a 132-SM card, or one part per query head."""
    assert torch_fa.bwd_parts(B, Sk, K, group, 132) == parts
    assert group % parts == 0


@pytest.mark.parametrize("case", ["cpu", "mixed_dtypes", "g_shape", "m_too_large"])
def test_adapter_fused_bwd_launcher_refuses_what_no_kernel_takes(case):
    h, g = torch.zeros(32, 64), torch.zeros(32, 64)
    wd, wu = torch.zeros(64, 16), torch.zeros(16, 64)
    if case == "mixed_dtypes":
        g = g.to(torch.bfloat16)
    elif case == "g_shape":
        g = torch.zeros(31, 64)
    elif case == "m_too_large":
        wd, wu = torch.zeros(64, 300), torch.zeros(300, 64)
    with pytest.raises(ValueError, match="CUDA" if case == "cpu" else None):
        torch_af.adapter_fused_bwd(g, h, wd, wu)


TRAIN_T = (1, 17, 300, 2047, 2048)     # one ragged tile, ragged ends, 4 x 512 tokens


@pytest.mark.parametrize("D", [1600, 2048, 2560, 4096])
@pytest.mark.parametrize("m", [16, 48, 64, 128])
def test_adapter_fused_bwd_tile_plan_at_training_shapes(m, D):
    """The bf16 backward's tile plan: it fits in shared memory, its cluster is
    one the card allows (at most 16 blocks, dividing the 64 rows), every row
    of g and h belongs to one tile and every column of D to one block, every
    row of the intermediate is reduced by one block, and no two regions of
    the layout overlap (each has room of its own). Where no cluster size
    fits (m 128 above D 2048), the 16-row kernel runs. Pure Python: the
    kernels run only on the card."""
    bt = torch_af.TILE_ROWS
    for T in TRAIN_T:
        kernel, p = torch_af.bwd_route(T, D, m, torch.bfloat16)
        if all(torch_af.bwd_tile_layout(D, m, c) is None for c in torch_af.TILE_CLUSTERS):
            assert m == 128 and D > 2048
            assert (kernel, p) == ("rows", None)
            continue
        assert kernel == "tile" and p == torch_af.bwd_tile_plan(T, D, m)
        assert p.cluster in (8, 16) and bt % p.cluster == 0 and p.smem <= torch_af.SMEM_LIMIT
        # clusters of 8 where they fit, else 16
        assert p.cluster == (8 if torch_af.bwd_tile_layout(D, m, 8) else 16)
        assert p.mp % 16 == 0 and m <= p.mp < m + 16
        tiles = -(-T // bt)
        assert (tiles - 1) * bt < T <= tiles * bt                   # rows: one tile each
        # ceil(D / cluster) columns per block, rounded up to 64, at most TILE_CHUNKS x 64
        assert p.dc == 64 * -(-(-(-D // p.cluster)) // 64) and p.cluster * p.dc >= D
        assert p.dc <= 64 * torch_af.TILE_CHUNKS
        owner = [d // p.dc for d in range(D)]                        # columns: one block each
        assert owner[0] == 0 and owner[-1] < p.cluster and owner == sorted(owner)
        reduced = sorted(t for r in range(p.cluster) for t in range(r, bt, p.cluster))
        assert reduced == list(range(bt))                            # intermediate rows
        mp64 = 64 * -(-m // 64)
        sizes = {"hs": 2 * bt * p.dc, "gs": 2 * bt * p.dc, "wd": 2 * mp64 * p.dc,
                 "wu": 2 * p.mp * p.dc, "pz": 4 * bt * (p.mp + 8), "pu": 4 * bt * (p.mp + 8),
                 "hi": 2 * bt * (p.mp + 8), "lo": 2 * bt * (p.mp + 8),
                 "bar": 8 * torch_af.TILE_CHUNKS}
        for k in ("hs", "gs", "wd", "wu"):                 # the TMA's swizzled tiles
            assert getattr(p, k) % 1024 == 0
        regions = sorted((getattr(p, k), n) for k, n in sizes.items())
        assert regions[0][0] == 0
        for (start, n), (nxt, _) in zip(regions, regions[1:]):
            assert start % 16 == 0 and start + n <= nxt
        assert 1024 + regions[-1][0] + -(-regions[-1][1] // 16) * 16 == p.smem


@pytest.mark.parametrize("T,D,m,dtype,kernel", [
    (2048, 2560, 64, torch.bfloat16, "tile"), (2048, 2048, 64, torch.bfloat16, "tile"),
    (2048, 2560, 64, torch.float32, "rows"), (2048, 2048, 64, torch.float32, "rows"),
    (300, 1001, 64, torch.bfloat16, "rows"), (300, 1000, 60, torch.bfloat16, "rows"),
    (2048, 2048, 256, torch.bfloat16, "rows"), (2048, 4096, 128, torch.bfloat16, "rows"),
    (4, 256, 16, torch.bfloat16, "tile"), (37, 4096, 64, torch.bfloat16, "tile")])
def test_adapter_fused_bwd_route_by_shape(T, D, m, dtype, kernel):
    """Which backward kernel a shape takes, by shape alone: bf16 takes the
    tile path wherever D and m are multiples of 8 and a plan fits (any T: up
    to 64 rows are one ragged tile); f32, D or m not a multiple of 8, and an
    m too large for any plan take the 16-row kernel."""
    assert torch_af.bwd_route(T, D, m, dtype).kernel == kernel


@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen2.5-3b"])
def test_adapter_fused_bwd_takes_the_tile_path_at_the_training_shapes(arch):
    """Both trained archs' adapter backward (4 x 512 tokens at the model's
    width and bottleneck, bf16) runs the tile path, in clusters of 8."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    D, m = cfg.d_model, cfg.adapter.bottleneck
    meta = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device="meta")
    kernel, p = torch_af.bwd_check(meta(2048, D), meta(2048, D), meta(D, m), meta(m, D), "gelu")
    assert (kernel, p.cluster, p.dc * p.cluster) == ("tile", 8, D)


@pytest.mark.parametrize("which", ["g", "h", "w_down", "w_up"])
def test_adapter_fused_bwd_check_sends_unaligned_data_to_rows(which):
    """The backward's tile path moves g, h and the weights by TMA, which
    takes 16-byte aligned rows only: a contiguous view at an odd offset goes
    to the 16-row kernel, by ``bwd_check``, which sees the data."""
    T, D, m = 300, 1024, 64
    shapes = {"g": (T, D), "h": (T, D), "w_down": (D, m), "w_up": (m, D)}
    ts = {k: torch.zeros(s, dtype=torch.bfloat16) for k, s in shapes.items()}
    args = lambda: (ts["g"], ts["h"], ts["w_down"], ts["w_up"], "gelu")
    assert torch_af.bwd_check(*args()).kernel == "tile"
    n = shapes[which][0] * shapes[which][1]
    ts[which] = torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(shapes[which])
    assert ts[which].is_contiguous() and ts[which].data_ptr() % 16
    assert torch_af.bwd_check(*args()) == ("rows", None)


def _bwd_tile_path_emulated(g, h, wd, wu, act, plan, parts=2):
    """The bf16 backward tile path's arithmetic on the CPU: each of the plan's
    blocks sums its columns' share of z = h @ W_down and u = g @ W_up^T in
    fp32 (bf16 products are exact), the cluster adds the partials in rank
    order, g_mid = u * act'(z) in fp32 is split into hi = bf16(g_mid) and lo =
    bf16(g_mid - hi), each block sums hi @ W_down^T + lo @ W_down^T over its
    own columns in fp32, and dh = bf16(g + bf16(term)). With ``parts=1`` only
    hi is used. Returns (dh, mid, g_mid, term)."""
    hf, gf, wdf, wuf = h.float(), g.float(), wd.float(), wu.float()
    D = h.shape[1]
    cols = [slice(r * plan.dc, min(D, (r + 1) * plan.dc)) for r in range(plan.cluster)
            if r * plan.dc < D]
    z, u = hf[:, cols[0]] @ wdf[cols[0]], gf[:, cols[0]] @ wuf[:, cols[0]].t()
    for c in cols[1:]:
        z, u = z + hf[:, c] @ wdf[c], u + gf[:, c] @ wuf[:, c].t()
    g_mid = u * ref.act_grad(act, z)
    hi = _bf16(g_mid)
    lo = _bf16(g_mid - hi)
    term = torch.cat([hi @ wdf[c].t() + (lo @ wdf[c].t() if parts == 2 else 0.0)
                      for c in cols], dim=1)
    return (gf + _bf16(term)).to(torch.bfloat16), ref.act(act, z), g_mid, term


@pytest.mark.parametrize("T,D,m", [(37, 256, 16), (300, 1000, 48), (130, 640, 64)])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
def test_adapter_fused_bwd_tile_split_matches_jax(T, D, m, act):
    """The bf16 backward tile path's arithmetic, emulated on the CPU, against
    jax.vjp of the JAX reference (``repro.kernels.ref.adapter_fused``): dh
    within one bf16 ulp of its largest entry (2**-7, the card tests'
    BWD_RTOL: fp32 sums in another order can round the term to the other
    side), and equal to it bit for bit on at least 99% of the elements; mid
    and g_mid within 1e-5 of the largest entry of the fp32 reference
    formulas. The hi/lo term stays within 2**-15 of |g_mid| @ |W_down^T| of
    the exact one; hi alone (one bf16 product) does not."""
    rng = np.random.default_rng(T + D + m)
    h_j, h_t = _pair(rng.standard_normal((T, D), np.float32), "bfloat16")
    g_j, g_t = _pair(rng.standard_normal((T, D), np.float32), "bfloat16")
    wd_j, wd_t = _pair(0.05 * rng.standard_normal((D, m), np.float32), "bfloat16")
    wu_j, wu_t = _pair(0.05 * rng.standard_normal((m, D), np.float32), "bfloat16")
    plan = torch_af.bwd_tile_plan(T, D, m)
    dh, mid, g_mid, term = _bwd_tile_path_emulated(g_t, h_t, wd_t, wu_t, act, plan)
    _, vjp = jax.vjp(lambda a: jax_ref.adapter_fused(a, wd_j, wu_j, activation=act), h_j)
    want = _np(vjp(g_j)[0])
    got = _np(dh)
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
    assert (got == want).mean() >= 0.99
    z = h_t.float() @ wd_t.float()
    want_g_mid = (g_t.float() @ wu_t.float().t()) * ref.act_grad(act, z)
    for a, b in ((mid, ref.act(act, z)), (g_mid, want_g_mid)):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    exact = g_mid.double() @ wd_t.double().t()
    scale = g_mid.double().abs() @ wd_t.double().abs().t()
    assert ((term.double() - exact).abs() <= 2.0 ** -15 * scale).all()
    term1 = _bwd_tile_path_emulated(g_t, h_t, wd_t, wu_t, act, plan, parts=1)[3]
    assert ((term1.double() - exact).abs() > 2.0 ** -15 * scale).any()


def test_attention_gradient_with_sinks_is_refused_and_serving_saves_nothing():
    """n_sink > 0 with a gradient goes through the autograd Function (its
    backward takes the sinks; the name is kept from when it was refused) and
    the gradient flows to q, k and v; where no input needs a gradient the
    call is the forward alone, as served: nothing saved, no graph."""
    q = torch.randn(1, 8, 2, 64, requires_grad=True)
    k = torch.randn(1, 8, 1, 64, requires_grad=True)
    out = ops.flash_attention(q, k, k, window=4, n_sink=2)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    dq, dk = torch.autograd.grad(out.sum(), (q, k))
    assert torch.isfinite(dq).all() and dq.abs().max() > 0 and dk.abs().max() > 0
    with torch.no_grad():
        out = ops.flash_attention(q, k, k, window=4, n_sink=2)
    assert out.grad_fn is None
    assert ops.adapter_fused(k.detach(), torch.zeros(64, 4),
                             torch.zeros(4, 64)).grad_fn is None
    assert ops.flash_attention(q, k, k).grad_fn is not None


@pytest.mark.parametrize("scan", ["rwkv_scan", "mamba_scan"])
def test_scan_kernel_gradient_is_refused(scan):
    """The scans' gradients flow through their autograd Functions (the name is
    kept from when they were refused). Off the CPU (a meta tensor stands for
    the card's) a call that needs a gradient goes to the kernel, whose
    launcher takes CUDA tensors only: it raises, never falling back to the
    plain version; on the CPU the plain forward and backward run, no launch
    counted, and the gradient is finite; with no gradient needed the call is
    the forward alone and saves nothing."""
    shapes = {"rwkv_scan": [(2, 4, 8)] * 4 + [(2, 1, 8), (2, 8, 8)],
              "mamba_scan": [(1, 4, 3, 2), (1, 4, 3, 2), (1, 4, 2), (1, 3, 2)]}[scan]
    fn = getattr(ops, scan)
    meta = [torch.zeros(s, device="meta") for s in shapes]
    meta[1].requires_grad_(True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*meta)
    cpu = [torch.randn(s) * 0.1 for s in shapes]
    cpu[1].requires_grad_(True)
    ops.reset_launches()
    out = fn(*cpu)[0]
    assert type(out.grad_fn).__name__ in ("_RwkvScanBackward", "_MambaScanBackward")
    out.sum().backward()
    assert cpu[1].grad is not None and torch.isfinite(cpu[1].grad).all()
    assert cpu[1].grad.abs().max() > 0
    assert ops.LAUNCHES[scan] == 0 and ops.LAUNCHES[f"{scan}_bwd"] == 0
    with torch.no_grad():
        outs = fn(*cpu)
    assert all(o.grad_fn is None for o in outs)
