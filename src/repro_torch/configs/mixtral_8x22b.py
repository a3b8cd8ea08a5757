"""Mixtral-8x22B — sparse MoE (8 experts, top-2) with sliding-window attn.
[arXiv:2401.04088 (Mixtral family); 8x22B model card]
"""
from repro_torch.models.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32_768, head_dim=128,
    num_experts=8, experts_per_token=2,
    sliding_window=4096,
    mlp_type="swiglu", norm_type="rmsnorm",
    lora=LoRAConfig(rank=16, alpha=32.0),
    source="arXiv:2401.04088",
)

SMOKE = CONFIG.with_(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                     head_dim=32, d_ff=256, vocab_size=512,
                     num_experts=4, experts_per_token=2, sliding_window=16)
