"""SmolLM-360M — llama-architecture small dense decoder.
[hf:HuggingFaceTB/SmolLM-135M family card, 360M variant]
"""
from repro_torch.models.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    d_ff=2560, vocab_size=49_152, head_dim=64,
    mlp_type="swiglu", norm_type="rmsnorm",
    lora=LoRAConfig(rank=16, alpha=32.0),
    source="hf:HuggingFaceTB/SmolLM-135M",
)

SMOKE = CONFIG.with_(num_layers=2, d_model=120, num_heads=3, num_kv_heads=1,
                     head_dim=40, d_ff=320, vocab_size=512)
