"""Mamba2-780M — attention-free SSM with the SSD (state-space duality)
algorithm; O(1)-state decode.
[arXiv:2405.21060]
"""
from repro_torch.models.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=50_280,
    ssm_state_dim=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=64,
    norm_type="rmsnorm",
    lora=LoRAConfig(rank=16, alpha=32.0, targets=("in", "out")),
    source="arXiv:2405.21060",
)

SMOKE = CONFIG.with_(num_layers=2, d_model=128, vocab_size=512,
                     ssm_state_dim=32, ssm_head_dim=32, ssm_chunk=8)
