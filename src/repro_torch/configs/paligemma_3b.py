"""PaliGemma-3B — VLM: SigLIP vision encoder (STUB frontend per assignment;
``input_specs`` provides 256 patch embeddings) + Gemma decoder with
prefix-LM attention over the image tokens.  [arXiv:2407.07726]
"""
from repro_torch.models.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    d_ff=16384, vocab_size=257_216, head_dim=256,
    num_image_tokens=256,
    mlp_type="swiglu", norm_type="rmsnorm",
    lora=LoRAConfig(rank=16, alpha=32.0),
    source="arXiv:2407.07726",
)

SMOKE = CONFIG.with_(num_layers=2, d_model=128, num_heads=4, num_kv_heads=1,
                     head_dim=32, d_ff=256, vocab_size=512,
                     num_image_tokens=8)
