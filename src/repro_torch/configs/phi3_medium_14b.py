"""Phi-3-medium (14B) — dense decoder, RoPE + SwiGLU + GQA.
[arXiv:2404.14219]
"""
from repro_torch.models.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
    d_ff=17920, vocab_size=100_352, head_dim=128,
    mlp_type="swiglu", norm_type="rmsnorm",
    lora=LoRAConfig(rank=16, alpha=32.0),
    source="arXiv:2404.14219",
)

SMOKE = CONFIG.with_(num_layers=2, d_model=160, num_heads=4, num_kv_heads=2,
                     head_dim=40, d_ff=320, vocab_size=512)
