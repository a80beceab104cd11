"""api of the PyTorch port (mirrors repro.api)."""
