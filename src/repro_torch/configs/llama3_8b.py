"""llama3-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 [arXiv:2407.21783]. Same numbers as
`repro.configs.llama3_8b`."""
from repro_torch.layers.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="transformer",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama3-8b-smoke", family="transformer",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=512, rope_theta=500000.0,
    attn_block_q=32, attn_block_kv=32, remat="none",
)
