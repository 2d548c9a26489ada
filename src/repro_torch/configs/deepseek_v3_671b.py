"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff(expert)=2048
vocab=129280, MLA (kv_lora=512, q_lora=1536), 1 shared + 256 routed
top-8, MTP [arXiv:2412.19437]. First 3 layers dense (d_ff=18432). Same
numbers as `repro.configs.deepseek_v3_671b`.
"""
from repro_torch.layers.common import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="transformer",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=18432, vocab_size=129280, mtp=True,
    moe=MoEConfig(num_experts=256, num_shared=1, top_k=8, d_expert=2048,
                  first_dense_layers=3),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
)

SKIP_SHAPES = ("long_500k",)

SMOKE = ModelConfig(
    name="deepseek-v3-671b-smoke", family="transformer",
    num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512, mtp=True,
    moe=MoEConfig(num_experts=8, num_shared=1, top_k=2, d_expert=64,
                  first_dense_layers=1),
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, qk_nope_dim=16,
                  qk_rope_dim=16, v_head_dim=16),
    attn_block_q=32, attn_block_kv=32, remat="none",
)

SKIP_SHAPES = ("long_500k",)
