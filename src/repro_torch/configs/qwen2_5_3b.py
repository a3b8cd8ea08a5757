"""Qwen2.5-3B — dense decoder with GQA and QKV bias.
[hf:Qwen/Qwen2.5-0.5B family card, 3B variant]
"""
from repro_torch.models.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
    d_ff=11008, vocab_size=151_936, head_dim=128,
    qkv_bias=True, mlp_type="swiglu", norm_type="rmsnorm",
    rope_theta=1_000_000.0,
    lora=LoRAConfig(rank=16, alpha=32.0),
    source="hf:Qwen/Qwen2.5-0.5B",
)

SMOKE = CONFIG.with_(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                     head_dim=32, d_ff=256, vocab_size=512)
