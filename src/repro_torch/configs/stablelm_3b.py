"""stablelm-3b [dense] — 32L d_model=2560 32H (MHA kv=32, head width 80)
d_ff=6912 vocab=50304 [hf:stabilityai/stablelm-2-1_6b family]. Same
numbers as `repro.configs.stablelm_3b`."""
from repro_torch.layers.common import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="transformer",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=6912, vocab_size=50304, rope_theta=10000.0,
)

SKIP_SHAPES = ("long_500k",)

SMOKE = ModelConfig(
    name="stablelm-3b-smoke", family="transformer",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=8,
    d_ff=256, vocab_size=512, attn_block_q=32, attn_block_kv=32,
    remat="none",
)

SKIP_SHAPES = ("long_500k",)
