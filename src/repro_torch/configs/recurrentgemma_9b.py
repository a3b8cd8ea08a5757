"""RecurrentGemma-9B — hybrid RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427 (Griffin); google/recurrentgemma-9b model card]
"""
from repro_torch.models.config import ATTN, REC, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256_000, head_dim=256,
    layer_pattern=(REC, REC, ATTN),
    sliding_window=2048,            # Griffin local attention window
    ssm_expand=1,                   # lru_width == d_model in RG-9B
    mlp_type="swiglu", norm_type="rmsnorm",
    lora=LoRAConfig(rank=16, alpha=32.0),
    source="arXiv:2402.19427",
)

SMOKE = CONFIG.with_(
    num_layers=3, d_model=128, num_heads=4, num_kv_heads=1, head_dim=32,
    d_ff=256, vocab_size=512, sliding_window=16,
    # REC scans run in ssm_chunk-aligned blocks; tiny serving tests use
    # prefill_chunk 8/16, which must be a multiple of this
    ssm_chunk=8)
