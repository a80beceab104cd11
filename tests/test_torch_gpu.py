"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked ``gpu``: each test decides inside itself whether a card is present and
skips without one (the kernels have no CPU mode). This file imports no JAX, so
it runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are the reference's (tests/test_kernels.py): adapter 1e-5 in f32
and 2e-2 in bf16, attention 1e-5 in f32 and 3e-2 in bf16. The bf16 adapter
also allows one bf16 ulp of each output (rtol 2**-7): its fp32 sums run in
another order than the plain version's, which can move ``h + up`` across a
rounding boundary where |h| > 4 and one ulp exceeds 2e-2.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402

ATOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 3e-2)}   # (adapter, attention)


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
