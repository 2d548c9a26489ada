"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552 [hf:THUDM/glm-4-9b]. Same numbers as
`repro.configs.glm4_9b`."""
from repro_torch.layers.common import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="transformer",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=151552, rope_theta=10000.0,
)

SKIP_SHAPES = ("long_500k",)

SMOKE = ModelConfig(
    name="glm4-9b-smoke", family="transformer",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=512, attn_block_q=32, attn_block_kv=32,
    remat="none",
)

SKIP_SHAPES = ("long_500k",)
