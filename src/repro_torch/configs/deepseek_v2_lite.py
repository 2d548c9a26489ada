"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400, MLA kv_lora=512, 2 shared + 64 routed experts top-6
[arXiv:2405.04434]. First layer dense (d_ff=10944, the released ratio).
Same numbers as `repro.configs.deepseek_v2_lite`.

MLA is a shipped instance of the paper's W = UV idea: the KV projection
is factored through a rank-512 latent and the latent is what gets cached.
"""
from repro_torch.layers.common import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite", family="transformer",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    moe=MoEConfig(num_experts=64, num_shared=2, top_k=6, d_expert=1408,
                  first_dense_layers=1),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke", family="transformer",
    num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512,
    moe=MoEConfig(num_experts=8, num_shared=1, top_k=2, d_expert=64,
                  first_dense_layers=1),
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_nope_dim=16,
                  qk_rope_dim=16, v_head_dim=16),
    attn_block_q=32, attn_block_kv=32, remat="none",
)

SKIP_SHAPES = ("long_500k",)
