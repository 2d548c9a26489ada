"""whisper-small [audio] — enc-dec, 12L enc + 12L dec, d_model=768 12H
d_ff=3072 vocab=51865 [arXiv:2212.04356]. Same numbers as
`repro.configs.whisper_small`. The conv frontend is a stub, as in the
reference: the encoder takes precomputed frame embeddings (b, t, d).
"""
from repro_torch.layers.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="whisper",
    num_layers=12, encoder_layers=12, d_model=768, num_heads=12,
    num_kv_heads=12, d_ff=3072, vocab_size=51865,
    max_source_positions=1500,
)

SKIP_SHAPES = ("long_500k",)

SMOKE = ModelConfig(
    name="whisper-small-smoke", family="whisper",
    num_layers=2, encoder_layers=2, d_model=128, num_heads=4,
    num_kv_heads=4, d_ff=256, vocab_size=512,
    max_source_positions=64, attn_block_q=32, attn_block_kv=32,
    remat="none",
)

SKIP_SHAPES = ("long_500k",)
