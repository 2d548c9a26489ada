"""chameleon-34b [vlm] — early-fusion VQ-token transformer: 48L
d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 [arXiv:2405.09818].
Image tokens are VQ codes inside the unified vocab, so the token stream
is the whole input. Same numbers as `repro.configs.chameleon_34b`."""
from repro_torch.layers.common import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="transformer",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=65536, rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="chameleon-34b-smoke", family="transformer",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=512, attn_block_q=32, attn_block_kv=32,
    remat="none",
)

SKIP_SHAPES = ("long_500k",)  # full attention: no 500k dense KV
