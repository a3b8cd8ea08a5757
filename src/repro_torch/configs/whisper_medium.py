"""Whisper-medium — encoder-decoder audio transformer.  The mel-spectrogram
+ conv feature extractor frontend is a STUB per assignment: ``input_specs``
provides precomputed frame embeddings (1500, d_model).  RoPE replaces the
original learned absolute positions (the reference's adaptation, which
the port copies).  [arXiv:2212.04356]
"""
from repro_torch.models.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=51_865, head_dim=64,
    encoder_layers=24, encoder_seq=1500, cross_attention=True,
    mlp_type="gelu", norm_type="layernorm", tie_embeddings=False,
    lora=LoRAConfig(rank=16, alpha=32.0),
    source="arXiv:2212.04356",
)

SMOKE = CONFIG.with_(num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
                     head_dim=32, d_ff=256, vocab_size=512,
                     encoder_layers=2, encoder_seq=16)
