"""zamba2-7b [hybrid] — 81L Mamba2 backbone + shared attention block,
d_model=3584 32H (kv=32) d_ff=14336 vocab=32000 ssm_state=64
[arXiv:2411.15242]. Same numbers as `repro.configs.zamba2_7b`: the
shared attention block (one weight set) runs before every group of
`attn_every` Mamba2 layers, and its head width is 3584 / 32 = 112."""
from repro_torch.layers.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="zamba",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, ssm_state=64, attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-7b-smoke", family="zamba",
    num_layers=5, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512, ssm_state=16, attn_every=2,
    attn_block_q=32, attn_block_kv=32, remat="none",
)

SKIP_SHAPES = ()
