"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked ``gpu``: each test decides inside itself whether a card is present and
skips without one (the kernels have no CPU mode). This file imports no JAX, so
it runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are the reference's (tests/test_kernels.py): adapter 1e-5 in f32
and 2e-2 in bf16, attention 1e-5 in f32 and 3e-2 in bf16. The bf16 adapter
also allows one bf16 ulp of each output (rtol 2**-7): its fp32 sums run in
another order than the plain version's, which can move ``h + up`` across a
rounding boundary where |h| > 4 and one ulp exceeds 2e-2. The bf16 prefill
path's cases allow one bf16 ulp of the up term on top (``_adapter_bound``):
the plain version rounds ``up`` to bf16 before the residual add, and fp32 sums
in another order can land that rounding one ulp apart; where h cancels a
large up term, that ulp exceeds the tolerance of the small output.

``rwkv_scan`` and ``mamba_scan`` are held to their plain versions relative
to the largest entry of each output (1e-4): both sum fp32 products in their
own order along a serial recurrence, and on the served models the outputs
reach 1e3 and more, where an absolute tolerance says nothing. Their backward
kernels are held to the plain backwards the same way, each gradient relative
to its largest entry (1e-4).

The backward kernels (training) are held to the plain backward versions on
the same inputs relative to each gradient's largest entry: 1e-4 in f32 (fp32
sums over up to 2048 rows in another order) and 2**-7 in bf16 (one bf16 ulp
of the largest entry: each gradient is rounded once to bf16, and dh twice, as
the reference rounds it). The row logsumexp to 1e-4 (the bf16 kernel sums
exponentials from ex2.approx). Through autograd, kernel forward and backward
against plain forward and backward, bf16 attention allows two ulps (2**-6):
the two forwards round o differently (the kernel's PV takes the unnormalised
exp(s - m) in bf16, the plain version the normalised P), and the backward's
rowsum(dO o) inherits that.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402

ATOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 3e-2)}   # (adapter, attention)
SCAN_RTOL = 1e-4     # rwkv_scan and mamba_scan, of the largest entry of each output
BWD_RTOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}   # backward, of each gradient's largest entry
PIPE_RTOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}  # attention forward and backward through autograd
ULP = 2.0 ** -7      # one bf16 ulp, relative


def _adapter_bound(h, wd, wu, act, want):
    """What a bf16 adapter output may differ from the plain version's
    ``want`` by, elementwise: atol 2e-2, one bf16 ulp of the output and one of
    the up term, which the plain version rounds to bf16 before the residual."""
    from repro_torch.kernels import ref

    up = (ref.act(act, h.float() @ wd.float()) @ wu.float()).to(torch.bfloat16).float()
    return ATOL["bfloat16"][0] + ULP * (want.float().abs() + up.abs())


def _assert_adapter_close(got, h, wd, wu, act, want):
    excess = (got.float() - want.float()).abs() - _adapter_bound(h, wd, wu, act, want)
    assert excess.max().item() <= 0, f"{excess.max().item()} beyond the tolerance"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_kernels_match_plain_on_card(dtype):
    """The CUDA kernels against their plain versions on the card (needs a GPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device="cuda") * scale).to(dt)
    atol_a, atol_f = ATOL[dtype]
    for T, D, m in ((4, 2048, 64), (300, 2048, 64), (300, 256, 16), (37, 256, 48)):
        h, wd, wu = rnd(T, D), rnd(D, m, scale=0.05), rnd(m, D, scale=0.05)
        for act in ("gelu", "relu", "silu"):
            got = ops.adapter_fused(h, wd, wu, activation=act)
            want = ops.adapter_fused(h, wd, wu, activation=act, impl="plain")
            # plus one bf16 ulp of each output: sums run in another order
            torch.testing.assert_close(got.float(), want.float(), atol=atol_a,
                                       rtol=2.0 ** -7 if dtype == "bfloat16" else 0.0)
    for S, window, hd in ((300, None, 128), (300, 128, 128), (130, None, 64)):
        q, k, v = rnd(2, S, 16, hd), rnd(2, S, 2, hd), rnd(2, S, 2, hd)
        got = ops.flash_attention(q, k, v, window=window)
        want = ops.flash_attention(q, k, v, window=window, impl="plain")
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol_f)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("T", [4, 2048])
@pytest.mark.parametrize("D", [4096, 4608])
def test_adapter_fused_wide_models_on_card(D, T, dtype):
    """rwkv6-7b's and starcoder2-7b's widths: the f32 tile does not fit in
    shared memory, so the kernel reads h rows from device memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(D + T)
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device="cuda") * scale).to(dt)
    h, wd, wu = rnd(T, D), rnd(D, 64, scale=0.05), rnd(64, D, scale=0.05)
    got = ops.adapter_fused(h, wd, wu)
    want = ops.adapter_fused(h, wd, wu, impl="plain")
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype][0],
                               rtol=2.0 ** -7 if dtype == "bfloat16" else 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("N,S,hd,state,strong", [
    (256, 202, 64, False, False), (256, 445, 64, True, False), (64, 130, 32, True, False),
    (8, 33, 16, True, False), (8, 1, 8, True, False), (64, 300, 64, True, True),
    (8, 37, 32, True, True), (8, 7, 8, True, True), (16, 1, 64, True, False),
    (16, 7, 64, True, False), (16, 33, 64, False, False), (4, 16, 16, True, False)])
def test_rwkv_scan_matches_plain_on_card(N, S, hd, state, strong):
    """Ragged S around and below the kernel's chunk of 16 steps, every head
    dim, and strong decays (log decays down to -e^3 = -20 a step, where a
    factorisation through e^{-ca} would overflow)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(S)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    r, k, v = rnd(N, S, hd), rnd(N, S, hd), rnd(N, S, hd)
    if strong:
        lw = -torch.exp(-6.0 + 9.0 * torch.rand(N, S, hd, generator=gen, device="cuda"))
    else:
        lw = -torch.exp(0.5 * rnd(N, S, hd) - 1.0)
    u = 0.5 * rnd(N, 1, hd)
    s0 = 0.1 * rnd(N, hd, hd) if state else torch.zeros(N, hd, hd, device="cuda")
    ops.reset_launches()
    out, sT = ops.rwkv_scan(r, k, v, lw, u, s0)
    assert ops.LAUNCHES["rwkv_scan"] == 1
    want, wT = ops.rwkv_scan(r, k, v, lw, u, s0, impl="plain")
    for got_, want_ in ((out, want), (sT, wT)):
        torch.testing.assert_close(got_, want_, rtol=0,
                                   atol=SCAN_RTOL * want_.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,D,N,state", [(4, 330, 1600, 16, False), (2, 37, 256, 8, False),
                                           (3, 9, 40, 32, False), (1, 1, 24, 4, False),
                                           (2, 70, 33, 16, False), (4, 330, 1600, 16, True),
                                           (3, 9, 40, 32, True), (1, 1, 24, 4, True)])
def test_mamba_scan_matches_plain_on_card(B, S, D, N, state):
    """hymba-1.5b's prefill shape, the reduced size, ragged S and D, N up to
    32; from no start state (zero) or a random one (a cache's ``ssm``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(S * N)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    log_a = -torch.exp(0.5 * rnd(B, S, D, N) - 1.0)
    b, c = 0.5 * rnd(B, S, D, N), rnd(B, S, N)
    s0 = 3.0 * rnd(B, D, N) if state else None
    ops.reset_launches()
    y, sT = ops.mamba_scan(log_a, b, c, s0)
    assert ops.LAUNCHES["mamba_scan"] == 1
    want, wT = ops.mamba_scan(log_a, b, c, s0, impl="plain")
    for got_, want_ in ((y, want), (sT, wT)):
        torch.testing.assert_close(got_, want_, rtol=0,
                                   atol=SCAN_RTOL * want_.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("S,window,n_sink", [(700, 256, 128), (300, 128, 100),
                                             (200, 64, 128), (260, 128, 0)])
def test_flash_attention_sinks_on_card(S, window, n_sink, dtype):
    """Sinks past the window (a whole or a part of a tile), sinks reaching
    into the window, and no sinks, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(S + n_sink)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    q, k, v = rnd(2, S, 10, 64), rnd(2, S, 2, 64), rnd(2, S, 2, 64)
    got = ops.flash_attention(q, k, v, window=window, n_sink=n_sink)
    want = ops.flash_attention(q, k, v, window=window, n_sink=n_sink, impl="plain")
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL[dtype][1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [256, 1600, 2048, 4096, 4608])
def test_adapter_fused_decode_cluster_on_card(D, dtype):
    """Decode rows (T <= 16) run as one thread block cluster of 16 blocks, which
    the card can launch; T = 17 runs the tile path. Every activation, m of 16,
    48 and 64, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import adapter_fused as af

    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(D)
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device="cuda") * scale).to(dt)
    tol = dict(atol=ATOL[dtype][0], rtol=2.0 ** -7 if dtype == "bfloat16" else 0.0)
    for T in (1, 3, 4, 16, 17):
        for m in (16, 48, 64):
            h, wd, wu = rnd(T, D), rnd(D, m, scale=0.05), rnd(m, D, scale=0.05)
            assert (af.cluster_size(T, D, m, dt) > 0) == (T <= af.SMALL_T)
            if T <= af.SMALL_T:
                assert af.cluster_occupancy(T, D, m, dt) > 0
            for act in ("gelu", "relu", "silu"):
                want = ops.adapter_fused(h, wd, wu, activation=act, impl="plain").float()
                ops.reset_launches()
                got = ops.adapter_fused(h, wd, wu, activation=act)
                assert ops.LAUNCHES["adapter_fused"] == 1
                torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", ["init", 0.05])
@pytest.mark.parametrize("D", [1600, 2048, 2560, 4096, 4608])
@pytest.mark.parametrize("m", [16, 48, 64, 128])
def test_adapter_fused_bf16_tile_path_on_card(m, D, scale):
    """The bf16 prefill path (tiles on the tensor cores, one cluster per tile
    splitting D) against the plain version: every activation, ragged T (rows
    past T masked) and widths that leave the last blocks of a cluster part or
    wholly empty (D 1600 over 8 blocks of 256 columns); the clusters fit on
    the card. Weights of the models' init scale (1/sqrt of the fan-in,
    ``models/params.py``) and of std 0.05, where at m 128 and D 4096 the up
    term reaches 8 and more: there one bf16 ulp of it (0.0625) is more than
    atol, so the bound allows that ulp (``_adapter_bound``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import adapter_fused as af

    gen = torch.Generator(device="cuda").manual_seed(D + m)
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device="cuda")
                                 * scale).to(torch.bfloat16)
    if scale == "init":
        wd, wu = rnd(D, m, scale=D ** -0.5), rnd(m, D, scale=m ** -0.5)
    else:
        wd, wu = rnd(D, m, scale=scale), rnd(m, D, scale=scale)
    for T in (17, 33, 100, 808, 1320, 1780, 2292):
        route = af.route(T, D, m, torch.bfloat16)
        assert route.kernel == "tile" and af.tile_occupancy(route.plan) > 0
        h = rnd(T, D)
        for act in ("gelu", "relu", "silu"):
            want = ops.adapter_fused(h, wd, wu, activation=act, impl="plain").float()
            ops.reset_launches()
            got = ops.adapter_fused(h, wd, wu, activation=act)
            assert ops.LAUNCHES["adapter_fused"] == 1
            _assert_adapter_close(got, h, wd, wu, act, want)


@pytest.mark.gpu
@pytest.mark.parametrize("T,D,m,kernel", [(300, 1001, 64, "rows"), (300, 1000, 50, "rows"),
                                          (77, 200, 256, "tile"), (40, 8192, 256, "rows")])
def test_adapter_fused_bf16_odd_shapes_on_card(T, D, m, kernel):
    """Widths and m that are not multiples of 8 (the tile path's TMA moves
    16-byte rows, so the 16-row CUDA-core kernel takes them), m = 256 (four
    groups of k-steps in the up-projection), a shape no tile plan fits, and h
    as a view at an odd offset (the 16-row kernel too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import adapter_fused as af

    assert af.route(T, D, m, torch.bfloat16).kernel == kernel
    gen = torch.Generator(device="cuda").manual_seed(T + D + m)
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device="cuda")
                                 * scale).to(torch.bfloat16)
    h, wd, wu = rnd(T, D), rnd(D, m, scale=0.05), rnd(m, D, scale=0.05)
    got = ops.adapter_fused(h, wd, wu)
    want = ops.adapter_fused(h, wd, wu, impl="plain")
    _assert_adapter_close(got, h, wd, wu, "gelu", want)
    odd = torch.empty(T * D + 1, dtype=torch.bfloat16, device="cuda")[1:].view(T, D)
    odd.copy_(h)
    assert af.check(odd, wd, wu, "gelu").kernel == "rows"
    _assert_adapter_close(ops.adapter_fused(odd, wd, wu), h, wd, wu, "gelu", want)


def _attention_cases():
    """(Sq, Sk, window, n_sink): the lengths around a 64-row tile, the served
    hymba prefill, a window, sinks that end inside a tile, and Sk > Sq."""
    cases = [(S, S, None, 0) for S in (1, 7, 63, 65, 130, 573)]
    cases += [(S, S, 128, 0) for S in (65, 573)]
    cases += [(S, S, 128, 100) for S in (130, 573)]
    cases += [(37, 100, None, 0), (65, 200, 128, 0), (7, 300, 128, 100)]
    return cases


# (query heads, KV heads, head_dim): qwen2.5-3b's, hymba-1.5b's, stablelm-3b's
# (MHA, head dim 80) and hd 80 with a GQA group of 8
HEADS = [(16, 2, 128), (25, 5, 64), (32, 32, 80), (16, 2, 80)]
HEAD_IDS = ["qwen", "hymba", "stablelm", "hd80_gqa"]


@pytest.mark.gpu
@pytest.mark.parametrize("heads", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("Sq,Sk,window,n_sink", _attention_cases())
def test_flash_attention_tensor_cores_on_card(Sq, Sk, window, n_sink, heads):
    """The bf16 tensor-core kernel (GQA groups 8, 5 and 1) against the plain
    version, with q, k and v taken as strided views of one fused
    [B, S, 3, H, hd] tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import flash_attention as fa

    H, K, hd = heads
    gen = torch.Generator(device="cuda").manual_seed(Sq * 1000 + Sk + H)
    qkv = torch.randn(2, Sk, 3, H, hd, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv[:, Sk - Sq:, 0], qkv[:, :, 1, :K], qkv[:, :, 2, :K]
    assert fa.kernel_for(q, k, v) == "tensor_cores" and not q.is_contiguous()
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, window=window, n_sink=n_sink)
    assert ops.LAUNCHES["flash_attention"] == 1
    want = ops.flash_attention(q, k, v, window=window, n_sink=n_sink, impl="plain")
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL["bfloat16"][1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("Sq,Sk,window", [(512, 512, None), (130, 130, 64), (37, 100, None)])
def test_flash_attention_hd80_on_card(Sq, Sk, window, dtype):
    """Head dim 80 (stablelm-3b's) against the plain version: the scalar
    kernel in f32, the tensor-core kernel in bf16; the forward with the row
    logsumexp returns the same output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import flash_attention as fa

    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(Sq + Sk + 80)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    q, k, v = rnd(2, Sq, 8, 80), rnd(2, Sk, 8, 80), rnd(2, Sk, 8, 80)
    want = ops.flash_attention(q, k, v, window=window, impl="plain")
    got = fa.flash_attention(q, k, v, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL[dtype][1])
    out, _ = fa.flash_attention(q, k, v, window=window, lse=True)
    assert torch.equal(out, got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("Sq,Sk,window", [(130, 130, None), (65, 200, 64)])
def test_flash_attention_not_causal_on_card(Sq, Sk, window, dtype):
    """causal=False (every key visible, or only the window's), both kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(Sq + Sk)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    q, k, v = rnd(2, Sq, 8, 128), rnd(2, Sk, 2, 128), rnd(2, Sk, 2, 128)
    got = ops.flash_attention(q, k, v, causal=False, window=window)
    want = ops.flash_attention(q, k, v, causal=False, window=window, impl="plain")
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL[dtype][1])


def _assert_grad_close(got, want, dtype, what, rtol=BWD_RTOL):
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= rtol[dtype] * scale, \
        f"{what}: {err} beyond {rtol[dtype]} x {scale}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
@pytest.mark.parametrize("T,D,m", [(2048, 2048, 64), (2048, 2560, 64), (300, 1000, 48),
                                   (4, 256, 16), (37, 4096, 64), (2047, 2560, 64),
                                   (300, 1600, 64)])
def test_adapter_fused_backward_on_card(T, D, m, act, dtype):
    """The backward kernel through ops' autograd Function against the plain
    backward (impl="plain") on the same inputs and cotangent: dh, dW_down,
    dW_up; and the kernel's mid and g_mid against their plain formulas. bf16
    runs the tile path at every one of these shapes (ragged tiles and D not a
    multiple of 64 among them), f32 the 16-row kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import adapter_fused as af
    from repro_torch.kernels import ref

    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(T + D + m)
    rnd = lambda *s, std=1.0: (std * torch.randn(s, generator=gen, device="cuda")).to(dt)
    h, g = rnd(T, D), rnd(T, D)
    wd, wu = rnd(D, m, std=0.05), rnd(m, D, std=0.05)
    route = "tile" if dt == torch.bfloat16 else "rows"
    assert af.bwd_check(g, h, wd, wu, act).kernel == route
    grads = {}
    for impl in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (h, wd, wu)]
        ops.reset_launches()
        out = ops.adapter_fused(*leaves, activation=act, impl=impl)
        grads[impl] = torch.autograd.grad(out, leaves, g)
        if impl == "kernel":
            assert ops.LAUNCHES["adapter_fused"] == 1 and ops.LAUNCHES["adapter_fused_bwd"] == 1
    for name, a, b in zip(("dh", "dw_down", "dw_up"), grads["kernel"], grads["plain"]):
        assert a.dtype == dt
        _assert_grad_close(a, b, dtype, name)
    if dt == torch.bfloat16:
        # dh rounds as the reference does (tests/test_torch_train.py pins the
        # plain version to it): equal bit for bit but where the fp32 sums of
        # the input term round to bf16 on either side of a boundary
        assert (grads["kernel"][0] == grads["plain"][0]).float().mean().item() >= 0.99
    _, mid, g_mid = af.adapter_fused_bwd(g, h, wd, wu, activation=act)
    z = h.float() @ wd.float()
    _assert_grad_close(mid, ref.act(act, z), "float32", "mid")
    _assert_grad_close(g_mid, (g.float() @ wu.float().t()) * ref.act_grad(act, z), "float32",
                       "g_mid")


def _backward_cases():
    """(Sq, Sk, window, causal): qwen2.5-3b's training shape, lengths around the
    64-row and 32-key tiles, a window, Sk > Sq, Sq > Sk (fully masked rows),
    not causal, and Sk a few 64-key tiles and a ragged one past Sq."""
    return [(512, 512, None, True), (65, 65, None, True), (130, 130, 48, True),
            (37, 100, None, True), (100, 37, None, True), (70, 90, 40, False),
            (200, 331, None, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("heads", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("Sq,Sk,window,causal", _backward_cases())
def test_flash_attention_backward_on_card(Sq, Sk, window, causal, heads, dtype):
    """The backward kernels against the plain backward on the same inputs (q,
    k, v, the kernel forward's o and lse, the cotangent); then through ops'
    autograd Function, kernels against plain versions. The forward's output
    with the row logsumexp is the served output, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    H, K, hd = heads
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(Sq * 1000 + Sk + H)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    q, k, v, dout = rnd(2, Sq, H, hd), rnd(2, Sk, K, hd), rnd(2, Sk, K, hd), rnd(2, Sq, H, hd)
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window, lse=True)
    assert torch.equal(out, fa.flash_attention(q, k, v, causal=causal, window=window))
    _, want_lse = ref.flash_attention(q, k, v, causal=causal, window=window, lse=True)
    finite = torch.isfinite(want_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    assert (lse[finite] - want_lse[finite]).abs().max().item() <= 1e-4
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, window=window)
    want = ref.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _assert_grad_close(a, b, dtype, name)
    grads = {}
    for impl in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ops.reset_launches()
        o = ops.flash_attention(*leaves, causal=causal, window=window, impl=impl)
        grads[impl] = torch.autograd.grad(o, leaves, dout)
        if impl == "kernel":
            assert ops.LAUNCHES["flash_attention"] == 1
            assert ops.LAUNCHES["flash_attention_bwd"] == 1
    for name, a, b in zip(("dq", "dk", "dv"), grads["kernel"], grads["plain"]):
        assert a.dtype == dt
        _assert_grad_close(a, b, dtype, f"{name} through autograd", PIPE_RTOL)
    if Sq > Sk and causal:
        assert torch.all(grads["kernel"][0][:, :Sq - Sk] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", HEADS, ids=HEAD_IDS)
def test_flash_attention_backward_split_on_card(heads):
    """The bf16 dK/dV blocks with the GQA group in every count of parts that
    bwd_parts chooses on this card (fp32 partial sums added in order by a
    second pass) against the plain backward: 64 queries against ragged key
    lengths, from one 64-key tile up to as many as it takes to choose one
    part."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch import device as dev_rule
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    H, K, hd = heads
    group, sms = H // K, dev_rule.sm_count(torch.device("cuda"))
    lengths = {}  # parts -> the first key length that gives it
    for n in range(1, sms + 1):
        lengths.setdefault(fa.bwd_parts(2, 64 * n - 17, K, group, sms), 64 * n - 17)
    assert sorted(lengths) == [p for p in range(1, group + 1) if group % p == 0]
    gen = torch.Generator(device="cuda").manual_seed(H + hd)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
    for parts, Sk in sorted(lengths.items()):
        q, k, v, dout = rnd(2, 64, H, hd), rnd(2, Sk, K, hd), rnd(2, Sk, K, hd), \
            rnd(2, 64, H, hd)
        out, lse = fa.flash_attention(q, k, v, lse=True)
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout)
        want = ref.flash_attention_bwd(q, k, v, out, lse, dout)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            _assert_grad_close(a, b, "bfloat16", f"{name}, {parts} parts, Sk {Sk}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_backward_kernels_are_deterministic_on_card(dtype):
    """Every backward kernel sums in a fixed order (no atomics): the same
    inputs give the same outputs bit for bit, call after call, at the
    adapter's widest shape of the card tests, at stablelm-3b's training shape
    (bf16: the tile path, its partial sums added across the cluster in rank
    order), at qwen2.5-3b's attention shape, at hymba-1.5b's attention with
    sinks, and (f32) for both scans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import adapter_fused as af
    from repro_torch.kernels import flash_attention as fa

    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(18)
    rnd = lambda *s, std=1.0: (std * torch.randn(s, generator=gen, device="cuda")).to(dt)
    h, g = rnd(37, 4096), rnd(37, 4096)
    wd, wu = rnd(4096, 64, std=0.05), rnd(64, 4096, std=0.05)
    q, k, v, dout = rnd(4, 512, 16, 128), rnd(4, 512, 2, 128), rnd(4, 512, 2, 128), \
        rnd(4, 512, 16, 128)
    out, lse = fa.flash_attention(q, k, v, lse=True)
    for act in ("gelu", "relu", "silu"):
        first = af.adapter_fused_bwd(g, h, wd, wu, activation=act)
        for _ in range(4):
            again = af.adapter_fused_bwd(g, h, wd, wu, activation=act)
            assert all(torch.equal(a, b) for a, b in zip(first, again)), act
    h, g = rnd(2048, 2560), rnd(2048, 2560)
    wd, wu = rnd(2560, 64, std=0.05), rnd(64, 2560, std=0.05)
    assert af.bwd_check(g, h, wd, wu, "gelu").kernel == ("tile" if dt == torch.bfloat16
                                                         else "rows")
    first = af.adapter_fused_bwd(g, h, wd, wu)
    for _ in range(4):
        again = af.adapter_fused_bwd(g, h, wd, wu)
        assert all(torch.equal(a, b) for a, b in zip(first, again)), "D 2560"
    first = fa.flash_attention_bwd(q, k, v, out, lse, dout)
    for _ in range(4):
        again = fa.flash_attention_bwd(q, k, v, out, lse, dout)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    # attention with sinks at hymba-1.5b's heads (a GQA group of 5 split into
    # bwd_parts parts in bf16), the window biting and the sinks ending inside a tile
    q, k, v, dout = rnd(4, 573, 25, 64), rnd(4, 573, 5, 64), rnd(4, 573, 5, 64), \
        rnd(4, 573, 25, 64)
    kw = dict(window=128, n_sink=100)
    out, lse = fa.flash_attention(q, k, v, lse=True, **kw)
    first = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    for _ in range(4):
        again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again)), "sinks"
    if dt != torch.float32:
        return
    # the scans (f32 only): rwkv_scan's at rwkv6-7b's head dim from a start
    # state, mamba_scan's at hymba-1.5b's width (dc summed over
    # its 1600 channels across blocks, then in block order)
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import rwkv_scan as rs

    r, kk, vv, do = rnd(64, 200, 64), rnd(64, 200, 64), rnd(64, 200, 64), rnd(64, 200, 64)
    lw, u = -torch.exp(0.5 * rnd(64, 200, 64) - 1.0), 0.5 * rnd(64, 1, 64)
    s0 = rnd(64, 64, 64)
    first = rs.rwkv_scan_bwd(r, kk, vv, lw, u, s0, do)
    for _ in range(4):
        again = rs.rwkv_scan_bwd(r, kk, vv, lw, u, s0, do)
        assert all(torch.equal(a, b) for a, b in zip(first, again)), "rwkv_scan_bwd"
    la, b, c = -torch.exp(0.5 * rnd(4, 130, 1600, 16) - 1.0), rnd(4, 130, 1600, 16), \
        rnd(4, 130, 16)
    _, _, ck = ms.mamba_scan(la, b, c, checkpoints=True)
    dy = rnd(4, 130, 1600)
    first = ms.mamba_scan_bwd(la, b, c, ck, dy)
    for _ in range(4):
        again = ms.mamba_scan_bwd(la, b, c, ck, dy)
        assert all(torch.equal(a, b_) for a, b_ in zip(first, again)), "mamba_scan_bwd"


@pytest.mark.gpu
@pytest.mark.parametrize("N,S,hd,state,strong", [
    (256, 512, 64, False, False), (256, 512, 64, True, True), (64, 130, 32, True, False),
    (8, 33, 16, True, True), (8, 1, 8, True, False), (16, 7, 64, False, False),
    (4, 16, 16, True, False), (8, 37, 8, False, True), (8, 4096, 64, True, True)])
def test_rwkv_scan_backward_on_card(N, S, hd, state, strong):
    """The backward kernel against the plain backward on the same inputs:
    rwkv6-7b's training shape (N 256 = 4 rows x 64 heads, S 512, hd 64) from
    a zero and a random start state, ragged S around the 16-step chunk,
    every head dim, decays down to -20 a step (where dlw's Phi walk must not
    divide by e^{lw}), and S 4096 with strong decays (the Phi walk's f32
    roundings, undamped by any decay, add up along S); then
    through ops' autograd Function (one launch each way) against the plain
    Function. At the served scale: r, k, v of std 8, a state of std 100."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv_scan as rs

    gen = torch.Generator(device="cuda").manual_seed(N + S + hd)
    rnd = lambda *s, std=1.0: std * torch.randn(s, generator=gen, device="cuda")
    r, k, v = rnd(N, S, hd, std=8.0), rnd(N, S, hd, std=8.0), rnd(N, S, hd, std=8.0)
    top = 3.0 if strong else -0.5
    lw = -torch.exp(-6.0 + (top + 6.0) * torch.rand(N, S, hd, generator=gen, device="cuda"))
    u = rnd(N, 1, hd, std=0.5)
    s0 = rnd(N, hd, hd, std=100.0) if state else torch.zeros(N, hd, hd, device="cuda")
    dout = rnd(N, S, hd)
    got = rs.rwkv_scan_bwd(r, k, v, lw, u, s0, dout)
    want = ref.rwkv_scan_bwd(r, k, v, lw, u, s0, dout)
    for name, a, b in zip(("dr", "dk", "dv", "dlw", "du", "dstate0"), got, want):
        _assert_grad_close(a, b, "float32", name, {"float32": SCAN_RTOL})
    grads = {}
    for impl in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (r, k, v, lw, u, s0)]
        ops.reset_launches()
        out, _ = ops.rwkv_scan(*leaves, impl=impl)
        grads[impl] = torch.autograd.grad((out * dout).sum(), leaves)
        if impl == "kernel":
            assert ops.LAUNCHES["rwkv_scan"] == 1 and ops.LAUNCHES["rwkv_scan_bwd"] == 1
    for a, b in zip(grads["kernel"], grads["plain"]):
        _assert_grad_close(a, b, "float32", "through autograd", {"float32": SCAN_RTOL})


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,D,N,state", [
    (4, 640, 1600, 16, False), (4, 330, 1600, 16, True), (2, 37, 256, 8, False),
    (3, 9, 40, 32, True), (1, 1, 24, 4, True), (2, 70, 33, 16, False), (2, 17, 10, 2, True)])
def test_mamba_scan_backward_on_card(B, S, D, N, state):
    """The backward kernel against the plain backward: hymba-1.5b's training
    shape (4 x 640 tokens with the meta tokens, 1600 channels, state 16),
    ragged S around the 16-step checkpoints and D not filling a block, N up
    to 32, from no start state and a random one; the forward with checkpoints is the served forward
    bit for bit; then through ops' autograd Function against the plain one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(S * N + D)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(rnd(B, S, D))[..., None]
    log_a = (dt * -torch.arange(1, N + 1, device="cuda", dtype=torch.float32)).contiguous()
    b = (dt * rnd(B, S, 1, N) * rnd(B, S, D, 1)).contiguous()
    c = rnd(B, S, N)
    s0 = 3.0 * rnd(B, D, N) if state else None
    dy = rnd(B, S, D)
    y, sT, ck = ms.mamba_scan(log_a, b, c, s0, checkpoints=True)
    y2, sT2 = ms.mamba_scan(log_a, b, c, s0)
    assert torch.equal(y, y2) and torch.equal(sT, sT2)
    assert ck.shape == (B, -(-S // ms.CHUNK), D, N)
    got = ms.mamba_scan_bwd(log_a, b, c, ck, dy)
    want = ref.mamba_scan_bwd(log_a, b, c, s0, dy)
    for name, a, w in zip(("dlog_a", "db", "dc", "dstate0"), got, want):
        _assert_grad_close(a, w, "float32", name, {"float32": SCAN_RTOL})
    grads = {}
    for impl in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (log_a, b, c)] + \
            ([] if s0 is None else [s0.clone().requires_grad_(True)])
        ops.reset_launches()
        yy, _ = ops.mamba_scan(*leaves[:3], leaves[3] if state else None, impl=impl)
        grads[impl] = torch.autograd.grad((yy * dy).sum(), leaves)
        if impl == "kernel":
            assert ops.LAUNCHES["mamba_scan"] == 1 and ops.LAUNCHES["mamba_scan_bwd"] == 1
    for a, w in zip(grads["kernel"], grads["plain"]):
        _assert_grad_close(a, w, "float32", "through autograd", {"float32": SCAN_RTOL})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("heads", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("Sq,Sk,window,n_sink", [(640, 640, 1024, 128), (573, 573, 128, 100),
                                                 (130, 130, 48, 64), (300, 300, 128, 128),
                                                 (37, 200, 64, 70), (200, 331, 96, 5)])
def test_flash_attention_backward_sinks_on_card(Sq, Sk, window, n_sink, heads, dtype):
    """The backward kernels with attention sinks against the plain backward:
    hymba-1.5b's training shape (640 tokens with its 128 meta tokens, window
    1024), the window biting with sinks that end inside a 64-key tile (100
    sinks at S 573), on a tile edge (64, 128), beyond Sq (Sk > Sq), and a few
    sinks; the forward's row logsumexp with sinks against the plain one, its
    output the served output bit for bit; then through ops' autograd
    Function against the plain Function."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    H, K, hd = heads
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(Sq + Sk + n_sink + H)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    q, k, v, dout = rnd(2, Sq, H, hd), rnd(2, Sk, K, hd), rnd(2, Sk, K, hd), rnd(2, Sq, H, hd)
    kw = dict(window=window, n_sink=n_sink)
    out, lse = fa.flash_attention(q, k, v, lse=True, **kw)
    assert torch.equal(out, fa.flash_attention(q, k, v, **kw))
    _, want_lse = ref.flash_attention(q, k, v, lse=True, **kw)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _assert_grad_close(a, b, dtype, name)
    grads = {}
    for impl in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ops.reset_launches()
        o = ops.flash_attention(*leaves, impl=impl, **kw)
        grads[impl] = torch.autograd.grad(o, leaves, dout)
        if impl == "kernel":
            assert ops.LAUNCHES["flash_attention"] == 1
            assert ops.LAUNCHES["flash_attention_bwd"] == 1
    for name, a, b in zip(("dq", "dk", "dv"), grads["kernel"], grads["plain"]):
        _assert_grad_close(a, b, dtype, f"{name} through autograd", PIPE_RTOL)


@pytest.mark.gpu
def test_ring_executor_replay_equals_eager_round_on_card():
    """The executor's round as a CUDA graph against the same round run
    eagerly from the same state (``make_fused_round`` on a copy of the
    executor's tensors): the losses and every parameter, moment and the step
    count, bit for bit, over the boundary's first round (warm-up, capture,
    replay) and a second one (replay). Reduced stablelm-3b in bf16, 8 layers
    as S = 4 stages, boundary 4 (two frozen stages, the packed conveyor).
    Bit for bit because the replay launches the kernels the capture
    recorded, on the same shapes, and none of them sums in an order that
    varies from run to run: the port's kernels add their partial sums in a
    fixed order, and cuBLAS chooses its algorithm by shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no CPU mode")
    import dataclasses

    from torch.utils._pytree import tree_leaves, tree_map

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.executor import RingExecutor, make_fused_round
    from repro_torch.core.unfreeze import UnfreezeSchedule
    from repro_torch.models import params as prm

    cfg = get_config("stablelm-3b").reduced(n_layers=8, repeats=8)
    cfg = dataclasses.replace(cfg, adapter=dataclasses.replace(cfg.adapter, zero_init_up=False))
    S, M, seq = 4, 2, 64
    tc = TrainConfig(learning_rate=1e-4, n_microbatches=M, batch_size=1, seq_len=seq)
    ex = RingExecutor(cfg, tc, prm.materialize(cfg, seed=0, device="cuda"), S, M,
                      schedule=UnfreezeSchedule(depths=(4,), interval=S))
    boundary = ex.boundary_at(0)
    assert boundary == 4
    gen = torch.Generator(device="cuda").manual_seed(25)
    for r in range(2):
        tokens, labels = (torch.randint(0, cfg.vocab_size, (S, M, 1, seq), generator=gen,
                                        device="cuda") for _ in range(2))
        eager = tuple(tree_map(torch.clone, x) for x in (ex.stage_blocks, ex.shared,
                                                          ex.opt_state))
        fn = make_fused_round(cfg, tc, n_stages=S, boundary=boundary, n_micro=M,
                              spans=ex.spans)
        want, _ = fn(*eager, tokens, labels)
        got = ex.round(tokens, labels)
        assert torch.equal(got["losses"], want), (r, got["losses"], want)
        mine = tree_leaves((ex.stage_blocks, ex.shared, ex.opt_state))
        for i, (a, b) in enumerate(zip(mine, tree_leaves(eager), strict=True)):
            assert torch.equal(a, b), f"round {r}: leaf {i} {tuple(a.shape)}"
    assert ex.compile_counts() == {"4/direct": 1}
    assert ex.capture_launches[(4, "direct")]["adapter_fused_bwd"] == S * (8 - 4) * M


@pytest.mark.gpu
def test_ring_executor_cached_replay_equals_direct_on_card():
    """The activation cache's rounds as CUDA graphs against the direct
    round's graph from the same state: the reduced bf16 stablelm-3b of the
    test above, 2 slots over 4 rounds (capture, capture, hit, hit), each
    round's losses and every tensor it writes bit for bit; the capture graph
    launches what the direct graph does, the cached graph Phase B's kernels
    alone ((L - b) M S forward launches of each kernel for b frozen layers)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no CPU mode")
    import dataclasses

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.executor import RingExecutor
    from repro_torch.core.unfreeze import UnfreezeSchedule
    from repro_torch.models import params as prm

    cfg = get_config("stablelm-3b").reduced(n_layers=8, repeats=8)
    cfg = dataclasses.replace(cfg, adapter=dataclasses.replace(cfg.adapter, zero_init_up=False))
    S, M, seq, L, b = 4, 2, 64, 8, 4
    tc = TrainConfig(learning_rate=1e-4, n_microbatches=M, batch_size=1, seq_len=seq)
    params = prm.materialize(cfg, seed=0, device="cuda")
    sched = UnfreezeSchedule(depths=(L - b,), interval=S)
    cached = RingExecutor(cfg, tc, params, S, M, schedule=sched, cache_capacity=2)
    direct = RingExecutor(cfg, tc, params, S, M, schedule=sched)
    gen = torch.Generator(device="cuda").manual_seed(26)
    slots = [tuple(torch.randint(0, cfg.vocab_size, (S, M, 1, seq), generator=gen,
                                 device="cuda") for _ in range(2)) for _ in range(2)]
    for r in range(4):
        for mine, theirs in zip(direct.trainable_tensors(), cached.trainable_tensors(),
                                strict=True):
            mine.copy_(theirs)
        got = cached.round(*slots[r % 2], slot=r % 2)
        want = direct.round(*slots[r % 2])
        assert got["cache_hit"] == (r >= 2) and got["boundary"] == b
        assert torch.equal(got["losses"], want["losses"]), (r, got["losses"], want["losses"])
        for i, (x, y) in enumerate(zip(cached.trainable_tensors(), direct.trainable_tensors(),
                                       strict=True)):
            assert torch.equal(x, y), f"round {r}: tensor {i} {tuple(x.shape)}"
    st = cached.cache.stats()
    assert (st["cache_hits"], st["cache_misses"], st["cache_evictions"]) == (2, 2, 0)
    assert cached.compile_counts() == {f"{b}/cached": 1, f"{b}/capture": 1}
    phase_b = (L - b) * M * S
    assert cached.capture_launches[(b, "cached")] == {
        "adapter_fused": phase_b, "flash_attention": phase_b, "adapter_fused_bwd": phase_b,
        "flash_attention_bwd": (L - b - 1) * M * S, "rwkv_scan": 0, "rwkv_scan_bwd": 0,
        "mamba_scan": 0, "mamba_scan_bwd": 0}
    assert cached.capture_launches[(b, "capture")] == direct.capture_launches[(b, "direct")]


@pytest.mark.gpu
def test_ring_session_resume_equals_uninterrupted_run_on_card(tmp_path):
    """A fused ``RingSession`` on the card (the reduced bf16 stablelm-3b of
    the tests above, 8 layers as S = 4 stages) runs 4 rounds across a
    boundary drop (3, 3, 2, 2 frozen stages), saving after round 2; a session
    restored from that file runs rounds 3 and 4 through its own CUDA graphs,
    and its losses and every tensor a round writes equal the uninterrupted
    run's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no CPU mode")
    import dataclasses

    from repro_torch.api import IntervalPolicy, RingSession
    from repro_torch.configs import TrainConfig, get_config

    cfg = get_config("stablelm-3b").reduced(n_layers=8, repeats=8)
    cfg = dataclasses.replace(cfg, adapter=dataclasses.replace(cfg.adapter, zero_init_up=False))
    S, M, seq = 4, 2, 64
    tc = TrainConfig(learning_rate=1e-4, n_microbatches=M, batch_size=1, seq_len=seq)
    policy = lambda: IntervalPolicy(initial_depth=2, interval=2 * S)
    quiet = lambda *a: None
    sess = RingSession.create(cfg, tc, backend="fused", n_stages=S, policy=policy(), log=quiet)
    path = str(tmp_path / "ring")
    want = []
    for r in range(4):
        want.append(sess.step().materialize())
        if r == 1:
            sess.save(path)
    assert [m.boundary for m in want] == [6, 6, 4, 4]
    state = [t.clone() for t in sess.backend.driver.trainable_tensors()]
    back = RingSession.restore(path, cfg, tc, policy=policy(), log=quiet)
    assert back.backend.driver.device.type == "cuda" and back.step_count == 2 * S
    got = [back.step().materialize() for _ in range(2)]
    assert [(m.loss, m.extras["losses"]) for m in got] == \
        [(m.loss, m.extras["losses"]) for m in want[2:]]
    for i, (a, b) in enumerate(zip(back.backend.driver.trainable_tensors(), state,
                                   strict=True)):
        assert torch.equal(a, b), f"tensor {i} {tuple(a.shape)}"
    assert back.backend.driver.compile_counts() == {"4/direct": 1}


@pytest.mark.gpu
def test_ring_tenants_joint_equals_solo_on_card():
    """Several tenants on the card: a joint cached session of 3 tenants
    (capture, capture, hit on 2 slots, one CUDA graph per (boundary, mode))
    against 3 solo cached sessions fed each tenant's stream, each owner's
    loss and every tensor a round writes bit for bit; each tenant's slice of
    the stacked state is a contiguous, 16-byte aligned tensor (the executor
    asserts it on the card), and the joint graph holds 3 times a solo graph's
    launches. The reduced bf16 stablelm-3b of the tests above, 8 layers as
    S = 4 stages, boundary 4 (the packed conveyor)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no CPU mode")
    import dataclasses

    from torch.utils._pytree import tree_leaves

    from repro_torch.api import IntervalPolicy, RingSession
    from repro_torch.api.data import RingDataSource
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models import params as prm

    cfg = get_config("stablelm-3b").reduced(n_layers=8, repeats=8)
    cfg = dataclasses.replace(cfg, adapter=dataclasses.replace(cfg.adapter, zero_init_up=False))
    S, M, seq, T = 4, 2, 64, 3
    tc = TrainConfig(learning_rate=1e-4, n_microbatches=M, batch_size=1, seq_len=seq)
    params = prm.materialize(cfg, seed=0, device="cuda")
    session = lambda **kw: RingSession.create(
        cfg, tc, backend="cached", n_stages=S, slots_per_epoch=2, params=params,
        policy=IntervalPolicy(initial_depth=4, interval=100 * S), log=lambda *a: None, **kw)
    joint = session(tenants=T)
    ex, recs = joint.backend.driver, []
    real = ex.round
    ex.round = lambda *a, **kw: (recs.append(real(*a, **kw)), recs[-1])[1]
    hits = [joint.step().materialize().cache_hit for _ in range(3)]
    assert hits == [False, False, True] and ex.tenant_hits == [1] * T
    for t in range(T):
        solo = session()
        solo.data = RingDataSource(cfg, tc, S, slots_per_epoch=2, tenant=t)
        for r, rec in enumerate(recs):
            m = solo.step()
            assert torch.equal(m.extras["losses"], rec["tenant_owner_losses"][:, t]), (t, r)
            assert torch.equal(m.loss, rec["tenant_losses"][t]), (t, r)
        sx = solo.backend.driver
        mine = tree_leaves((ex.export_adapters(t), ex.export_tenant_opt(t)))
        theirs = tree_leaves((sx.export_adapters(0), sx.export_tenant_opt(0)))
        for i, (a, b) in enumerate(zip(mine, theirs, strict=True)):
            assert torch.equal(a, b), f"tenant {t}: leaf {i} {tuple(a.shape)}"
        for mode in ("capture", "cached"):
            assert {k: T * n for k, n in sx.capture_launches[(4, mode)].items()} == \
                ex.capture_launches[(4, mode)], mode


@pytest.mark.gpu
def test_ring_elastic_crash_rejoin_equals_fresh_executor_on_card():
    """The elastic ring on the card: a cached session (the reduced bf16
    stablelm-3b of the tests above, 8 layers as S = 4 stages, 2 slots, depth
    3) loses device 1 before round 2 and takes it back before round 5. Every
    round, before and after each change, equals a from-scratch direct
    executor at the live spans, seeded with the state before the round
    (``torch.equal`` on the losses and every tensor a round writes): the
    graphs of the old geometry are dropped, not replayed. The boundary falls
    from 4 to 3 at the crash (spans 3, 3, 2) and rises back to 4 at the
    rejoin; the state tensors are never reallocated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no CPU mode")
    import dataclasses

    from repro_torch.api import IntervalPolicy, RingSession
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.executor import RingExecutor
    from repro_torch.models import params as prm

    cfg = get_config("stablelm-3b").reduced(n_layers=8, repeats=8)
    cfg = dataclasses.replace(cfg, adapter=dataclasses.replace(cfg.adapter, zero_init_up=False))
    S, M, seq = 4, 2, 64
    tc = TrainConfig(learning_rate=1e-4, n_microbatches=M, batch_size=1, seq_len=seq)
    params = prm.materialize(cfg, seed=0, device="cuda")
    policy = lambda: IntervalPolicy(initial_depth=3, interval=100 * S)
    sess = RingSession.create(cfg, tc, backend="cached", n_stages=S, slots_per_epoch=2,
                              params=params, policy=policy(), chaos=["2:crash:1", "5:join:1"],
                              elastic=True, log=lambda *a: None)
    ex = sess.backend.driver
    ptrs = [t.data_ptr() for t in ex.trainable_tensors()]
    boundaries, hits = [], []
    for r in range(8):
        slot, tokens, labels = sess.data.next()
        before, step = [t.clone() for t in ex.trainable_tensors()], ex.step
        m = sess.step((slot, tokens, labels))
        rows = sess.backend.survivors
        twin = RingExecutor(cfg, tc, params, ex.S, M, spans=ex.spans, schedule=policy())
        for a, b in zip(twin.trainable_tensors(), before, strict=True):
            a.copy_(b)
        twin.step = step
        want = twin.round(tokens[rows], labels[rows])
        assert torch.equal(m.extras["losses"], want["losses"]), r
        for i, (a, b) in enumerate(zip(ex.trainable_tensors(), twin.trainable_tensors(),
                                       strict=True)):
            assert torch.equal(a, b), f"round {r}: tensor {i} {tuple(a.shape)}"
        boundaries.append(m.boundary)
        hits.append(m.cache_hit)
        del twin
    assert boundaries == [4, 4, 3, 3, 3, 4, 4, 4]
    assert hits == [False] * 4 + [True, False, False, True]
    assert [t.data_ptr() for t in ex.trainable_tensors()] == ptrs and ex.S == S


# mbert-squad's training shapes: h [4 x 512, 768], m 48 (a bf16 cluster of 8
# blocks with 128 columns each: blocks 6 and 7 own no column); attention
# [4, 512, 12, 64], MHA
MBERT_D, MBERT_M, MBERT_HEADS = 768, 48, (12, 12, 64)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
@pytest.mark.parametrize("T", [1, 100, 512, 2048])
def test_adapter_fused_mbert_width_on_card(T, act, dtype):
    """The adapter and its backward at mbert-squad's width against their
    plain versions: the decode cluster at T = 1, the bf16 tiles (forward and
    backward) with two column-less blocks in each cluster of 8, the f32
    kernels; through ops' autograd Function, one launch of each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import adapter_fused as af

    dt = getattr(torch, dtype)
    D, m = MBERT_D, MBERT_M
    gen = torch.Generator(device="cuda").manual_seed(T + 7)
    rnd = lambda *s, std=1.0: (std * torch.randn(s, generator=gen, device="cuda")).to(dt)
    h, g = rnd(T, D), rnd(T, D)
    wd, wu = rnd(D, m, std=0.05), rnd(m, D, std=0.05)
    if dt == torch.bfloat16 and T > af.SMALL_T:
        assert af.route(T, D, m, dt).plan.cluster * af.route(T, D, m, dt).plan.dc > D
        assert af.bwd_route(T, D, m, dt).kernel == "tile"
    grads = {}
    for impl in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (h, wd, wu)]
        ops.reset_launches()
        out = ops.adapter_fused(*leaves, activation=act, impl=impl)
        grads[impl] = (out.detach(),) + torch.autograd.grad(out, leaves, g)
        if impl == "kernel":
            assert ops.LAUNCHES["adapter_fused"] == 1 and ops.LAUNCHES["adapter_fused_bwd"] == 1
    got, want = grads["kernel"], grads["plain"]
    if dt == torch.bfloat16:
        _assert_adapter_close(got[0], h, wd, wu, act, want[0])
    else:
        torch.testing.assert_close(got[0], want[0], atol=ATOL[dtype][0], rtol=0.0)
    for name, a, b in zip(("dh", "dw_down", "dw_up"), got[1:], want[1:]):
        assert a.dtype == dt
        _assert_grad_close(a, b, dtype, name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_mbert_mha_on_card(dtype):
    """Attention forward and backward at mbert-squad's [4, 512, 12, 64]
    (MHA at hd 64, causal, no window): the kernels against the plain
    versions on the same inputs, then through ops' autograd Function."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    H, K, hd = MBERT_HEADS
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(512)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    q, k, v, dout = rnd(4, 512, H, hd), rnd(4, 512, K, hd), rnd(4, 512, K, hd), rnd(4, 512, H, hd)
    out, lse = fa.flash_attention(q, k, v, lse=True)
    want = ops.flash_attention(q, k, v, impl="plain")
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=ATOL[dtype][1])
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout)
    for name, a, b in zip(("dq", "dk", "dv"), got,
                          ref.flash_attention_bwd(q, k, v, out, lse, dout)):
        _assert_grad_close(a, b, dtype, name)
    grads = {}
    for impl in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = ops.flash_attention(*leaves, impl=impl)
        grads[impl] = torch.autograd.grad(o, leaves, dout)
    for name, a, b in zip(("dq", "dk", "dv"), grads["kernel"], grads["plain"]):
        _assert_grad_close(a, b, dtype, f"{name} through autograd", PIPE_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,vocab,seq", [("stablelm-3b", None, 64),
                                            ("stablelm-3b", 50304, 1024),
                                            ("mbert-squad", None, 64),
                                            ("olmoe-1b-7b", None, 64),
                                            ("rwkv6-7b", None, 64),
                                            ("hymba-1.5b", None, 64)],
                         ids=["lm", "lm_chunked_ce", "qa", "moe", "rwkv", "hymba"])
def test_pjit_graph_equals_eager_step_on_card(arch, vocab, seq):
    """``PjitBackend``'s graphed steps against the eager backend's, from the
    same weights on the same batches, with ``torch.equal``: the metrics and
    every adapter, head, moment and the step count, across a boundary walk
    (3, 3, 2, 2, 1, 1 frozen layers of 4) and a ``load_state`` into the
    graphed backend (after a step on other data, which it undoes: the graph
    reads the loaded values, the tensors keep their addresses). Reduced
    configs of 4 layers in bf16: an LM, the LM at stablelm-3b's vocab with
    1024 tokens a row (the cross-entropy in checkpointed chunks of 512, whose
    recompute the graph captures), mbert-squad's QA step, and olmoe's moe
    layers (the dispatch's sorts and gathers in the graph; moe_aux and
    moe_z among the metrics), rwkv6-7b's and hymba-1.5b's (the scans'
    backward kernels, attention's with 128 sinks). A capture records the
    step's launches (L forward of each kernel on the path, d of the
    adapter's backward, d - 1 of each other backward) and a replay launches
    none from Python; one build a boundary."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no CPU mode")
    import dataclasses

    from torch.utils._pytree import tree_map

    from repro_torch.api import IntervalPolicy
    from repro_torch.api.backends import PjitBackend
    from repro_torch.api.data import PjitDataSource
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models import params as prm

    over = {} if vocab is None else {"vocab_size": vocab}
    cfg = get_config(arch).reduced(n_layers=4, repeats=4, **over)
    cfg = dataclasses.replace(cfg, adapter=dataclasses.replace(cfg.adapter, zero_init_up=False))
    L = cfg.n_layers
    tc = TrainConfig(batch_size=2, seq_len=seq, warmup_steps=2)
    params = prm.materialize(cfg, seed=0, device="cuda")
    policy = lambda: IntervalPolicy(initial_depth=1, interval=2)
    graphed = PjitBackend(cfg, tc, policy(), params=tree_map(torch.clone, params))
    eager = PjitBackend(cfg, tc, policy(), params=params, graphs=False)
    assert graphed.graphs and not eager.graphs
    ptrs = [t.data_ptr() for t in graphed.state_tensors()]
    data, other = PjitDataSource(cfg, tc), PjitDataSource(cfg, TrainConfig(
        batch_size=2, seq_len=seq, seed=1))
    for s in range(6):
        if s == 4:                              # a resume: diverge, then load the state
            st = eager.state()
            saved = tree_map(torch.clone, {"params": st["params"], "opt": st["opt"]})
            graphed.step(other.next())
            graphed.load_state(saved["params"], saved["opt"], step=eager._step)
        batch = data.next()
        ops.reset_launches()
        got = graphed.step(batch)
        replayed = dict(ops.LAUNCHES)
        want = eager.step(batch)
        assert got["boundary"] == want["boundary"] == 3 - s // 2
        assert torch.equal(got["loss"], want["loss"]), (s, got["loss"], want["loss"])
        assert set(got["extras"]) == set(want["extras"])
        for k, v in want["extras"].items():
            assert torch.equal(got["extras"][k], v), (s, k)
        for i, (a, b) in enumerate(zip(graphed.state_tensors(), eager.state_tensors(),
                                       strict=True)):
            assert torch.equal(a, b), f"step {s}: leaf {i} {tuple(a.shape)}"
        d = L - got["boundary"]
        kind = cfg.pattern[0][0]
        attn, rwkv, ssm = kind != "rwkv", kind == "rwkv", kind == "hymba"
        assert graphed.capture_launches[graphed.last_key] == {
            "adapter_fused": L, "adapter_fused_bwd": d, "flash_attention": L * attn,
            "flash_attention_bwd": (d - 1) * attn, "rwkv_scan": L * rwkv,
            "rwkv_scan_bwd": (d - 1) * rwkv, "mamba_scan": L * ssm,
            "mamba_scan_bwd": (d - 1) * ssm}
        if s in (1, 3, 4, 5):                   # a replay: nothing launched from Python
            assert not any(replayed.values()), (s, replayed)
    assert [t.data_ptr() for t in graphed.state_tensors()] == ptrs
    assert graphed.compile_count == eager.compile_count == 3
    assert [k[0] for k in graphed._graphs] == [1]     # the higher boundaries' graphs dropped


SLICE_WIDTHS = [4608, 5120]          # starcoder2-7b's and llama4-maverick's d_model


@pytest.mark.gpu
@pytest.mark.parametrize("T", [4, 512, 2048])
@pytest.mark.parametrize("D", SLICE_WIDTHS)
def test_adapter_fused_slice_widths_on_card(D, T):
    """The bf16 adapter and its backward at starcoder2-7b's and llama4's
    widths against their plain versions, through ops' autograd Function (one
    launch of each): decode's cluster at T 4 (288 and 320 columns a block),
    the tile path's cluster of 16 blocks of 320 columns at a ring
    microbatch's 512 rows and a step's 2048 (at D 4608 block 14 owns 128
    columns and block 15 none)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import adapter_fused as af

    dt = torch.bfloat16
    route = af.route(T, D, 64, dt)
    if T > af.SMALL_T:
        assert route.kernel == "tile" and (route.plan.cluster, route.plan.dc) == (16, 320)
    else:
        assert route.kernel == "cluster" and route.plan.dc == -(-D // 16)
    assert af.bwd_route(T, D, 64, dt).kernel == "tile"
    gen = torch.Generator(device="cuda").manual_seed(D + T)
    rnd = lambda *s, std=1.0: (std * torch.randn(s, generator=gen, device="cuda")).to(dt)
    h, g = rnd(T, D), rnd(T, D)
    wd, wu = rnd(D, 64, std=0.05), rnd(64, D, std=0.05)
    grads = {}
    for impl in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (h, wd, wu)]
        ops.reset_launches()
        out = ops.adapter_fused(*leaves, impl=impl)
        grads[impl] = (out.detach(),) + torch.autograd.grad(out, leaves, g)
        if impl == "kernel":
            assert ops.LAUNCHES["adapter_fused"] == 1 and ops.LAUNCHES["adapter_fused_bwd"] == 1
    got, want = grads["kernel"], grads["plain"]
    _assert_adapter_close(got[0], h, wd, wu, "gelu", want[0])
    for name, a, b in zip(("dh", "dw_down", "dw_up"), got[1:], want[1:]):
        _assert_grad_close(a, b, "bfloat16", name)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [4, 1])
def test_flash_attention_gqa9_on_card(B):
    """starcoder2-7b's attention, 36 query heads over 4 KV heads of 128 (a
    GQA group of 9), causal over 512 tokens, forward and backward in bf16
    against the plain versions: at a step's 4 rows the dK/dV blocks take the
    group in 3 parts, at a ring microbatch's 1 row in 9 (132 SMs), the first
    splits that are not powers of two."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch import device as dev_rule
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    H, K, hd, S = 36, 4, 128, 512
    sms = dev_rule.sm_count(torch.device("cuda"))
    parts = fa.bwd_parts(B, S, K, H // K, sms)
    if sms == 132:
        assert parts == {4: 3, 1: 9}[B]
    gen = torch.Generator(device="cuda").manual_seed(36 + B)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v, dout = rnd(B, S, H, hd), rnd(B, S, K, hd), rnd(B, S, K, hd), rnd(B, S, H, hd)
    out, lse = fa.flash_attention(q, k, v, lse=True)
    want = ops.flash_attention(q, k, v, impl="plain")
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=ATOL["bfloat16"][1])
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout)
    for name, a, b in zip(("dq", "dk", "dv"), got,
                          ref.flash_attention_bwd(q, k, v, out, lse, dout)):
        _assert_grad_close(a, b, "bfloat16", f"{name}, {parts} parts")
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # the parts' sum in order


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_dispatch_graph_replay_equals_eager_on_card(dtype):
    """olmoe-1b-7b's moe FFN at its published widths (d_model 2048, 64
    experts top 8, d_expert 1024) on a ring microbatch's 512 tokens (C = 80):
    the forward, moe_aux, moe_z and the input gradient captured in one CUDA
    graph and replayed on new inputs equal the eager call's, bit for bit, and
    eager calls repeat bit for bit (every kept slot written once, no
    atomics), with ties in the bf16 router's logits broken to the lower
    expert as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import blocks
    from repro_torch.models import params as prm

    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), dtype=dtype)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(7)
    p = {name: prm._init_leaf(pd, dt, gen, torch.device("cuda"))
         for name, pd in prm.moe_defs(cfg).items()}
    assert blocks.moe_capacity(cfg, 512) == 80

    def run(x):
        x = x.detach().requires_grad_(True)
        out, aux = blocks.moe_ffn(cfg, p, x)
        (gx,) = torch.autograd.grad(out.float().square().sum(), x)
        return out.detach(), aux["moe_aux"].detach(), aux["moe_z"].detach(), gx

    xs = [torch.randn(1, 512, cfg.d_model, generator=gen, device="cuda").to(dt)
          for _ in range(3)]
    static = xs[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(static)                                   # warm-up on the capture stream
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            captured = run(static)
    torch.cuda.current_stream().wait_stream(side)
    for x in xs[1:]:
        static.copy_(x)
        graph.replay()
        eager, again = run(x), run(x)
        for a, b, c in zip(captured, eager, again):
            assert torch.equal(a, b) and torch.equal(b, c)
    # a router of zeros ties every probability: the lower experts win
    zero = {**p, "router": torch.zeros_like(p["router"])}
    probs = torch.softmax((xs[0].reshape(512, -1) @ zero["router"]).float(), -1)
    assert blocks.moe_topk(probs, 8)[1].eq(torch.arange(8, device="cuda")).all()
