"""RingAda in PyTorch for NVIDIA Hopper: the port of the JAX package ``repro``.

It serves dense, RWKV-6 and Hymba decoders (``launch.serve``) and trains a
dense decoder on one device with scheduled unfreezing (``launch.train``)
through hand-written CUDA kernels (``kernels/``), forward and backward.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; see
:mod:`repro_torch.device`.
"""
