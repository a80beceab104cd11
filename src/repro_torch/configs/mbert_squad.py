"""The paper's own evaluation model: mBERT (bert-base-multilingual) + SQuAD QA.

12L d_model=768 12H d_ff=3072 vocab=119547, learned positions, LayerNorm +
GELU with FFN biases, MAD-X style adapters (bottleneck 48), and a span head
of 2 outputs (start and end logits) trained with ``qa_span_loss``. As the
reference does, the port runs its attention causally.
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="mbert-squad",
    family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=119547,
    pattern=(("dense", 1),),
    rope=False,                      # learned positional embeddings
    norm="layernorm",
    glu=False, activation="gelu",
    head_out=2,                      # SQuAD span head (start/end logits)
    adapter=AdapterConfig(bottleneck=48),
    max_seq_len=512,
    source="arXiv:1810.04805 + arXiv:1606.05250 (paper's own eval setup)",
))
