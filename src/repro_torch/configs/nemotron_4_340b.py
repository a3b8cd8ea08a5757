"""Nemotron-4-340B — dense decoder, GQA, squared-ReLU MLP.
[arXiv:2402.16819 / 2406.11704]
"""
from repro_torch.models.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256_000, head_dim=192,
    mlp_type="squared_relu", norm_type="layernorm",
    tie_embeddings=False,
    lora=LoRAConfig(rank=16, alpha=32.0),
    source="arXiv:2402.16819",
)

SMOKE = CONFIG.with_(num_layers=2, d_model=192, num_heads=8, num_kv_heads=2,
                     head_dim=24, d_ff=768, vocab_size=512)
