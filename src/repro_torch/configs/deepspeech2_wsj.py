"""deepspeech2_wsj — the paper's own architecture.

Forward-only GRU Deep Speech 2 with the paper's Appendix-B choices:
mel-80 features (B.3), growing GRU sizes 768/1024/1280 (B.1), FC 1536,
CTC over a character vocabulary, partially-joint GRU factorization (B.2).
Same numbers as `repro.configs.deepspeech2_wsj`.
"""
from repro_torch.layers.common import ModelConfig

CONFIG = ModelConfig(
    name="deepspeech2-wsj", family="deepspeech",
    num_layers=3, d_model=1280, num_heads=1, num_kv_heads=1,
    d_ff=1536, vocab_size=32,               # blank + 26 chars + punct
    feat_dim=80, gru_dims=(768, 1024, 1280), fc_dim=1536,
    conv_channels=32, time_stride=2,
)

SMOKE = ModelConfig(
    name="deepspeech2-wsj-smoke", family="deepspeech",
    num_layers=3, d_model=96, num_heads=1, num_kv_heads=1,
    d_ff=128, vocab_size=32,
    feat_dim=80, gru_dims=(64, 80, 96), fc_dim=128,
    conv_channels=8, time_stride=2, remat="none",
)
