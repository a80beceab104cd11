"""RingAda in PyTorch for NVIDIA Hopper: the port of the JAX package ``repro``.

It serves dense decoders (``launch.serve``) through two hand-written CUDA
kernels, ``adapter_fused`` and ``flash_attention`` (``kernels/``). Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; see :mod:`repro_torch.device`.
"""
