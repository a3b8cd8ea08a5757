"""Llama-2-13B — the paper's second serving backbone. [arXiv:2307.09288]"""
from repro_torch.models.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama2-13b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=13824, vocab_size=32_000, head_dim=128,
    mlp_type="swiglu", norm_type="rmsnorm", tie_embeddings=False,
    lora=LoRAConfig(rank=16, alpha=32.0),
    source="arXiv:2307.09288",
)

SMOKE = CONFIG.with_(num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
                     head_dim=32, d_ff=256, vocab_size=512)
