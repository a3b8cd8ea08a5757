"""Grok-1 (314B) — sparse MoE (8 experts, top-2).
[hf:xai-org/grok-1 model card]
"""
from repro_torch.models.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131_072, head_dim=128,
    num_experts=8, experts_per_token=2,
    mlp_type="swiglu", norm_type="rmsnorm",
    lora=LoRAConfig(rank=16, alpha=32.0),
    source="hf:xai-org/grok-1",
)

SMOKE = CONFIG.with_(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                     head_dim=32, d_ff=256, vocab_size=512,
                     num_experts=4, experts_per_token=2)
