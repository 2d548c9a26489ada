"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, qk_norm, head_dim=128 [hf:Qwen/Qwen3 family]. Same numbers
as `repro.configs.qwen3_4b`."""
from repro_torch.layers.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="transformer",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=9728, vocab_size=151936, head_dim=128, qk_norm=True,
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen3-4b-smoke", family="transformer",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=32, qk_norm=True,
    attn_block_q=32, attn_block_kv=32, remat="none",
)

SKIP_SHAPES = ("long_500k",)
