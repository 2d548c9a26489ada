"""xlstm-350m [ssm] — 24L (12 mLSTM/sLSTM pairs) d_model=1024 4H
vocab=50304 [arXiv:2405.04517]. Same numbers as `repro.configs.xlstm_350m`:
d_ff=0, the blocks carry their own projections. The sLSTM's recurrent
kernel is the paper's `rec` group (lambda_rec); the mLSTM's projections
are `nonrec`."""
from repro_torch.layers.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="xlstm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
)

SKIP_SHAPES = ()

SMOKE = ModelConfig(
    name="xlstm-350m-smoke", family="xlstm",
    num_layers=4, d_model=128, num_heads=2, num_kv_heads=2,
    d_ff=0, vocab_size=512, remat="none",
)

SKIP_SHAPES = ()
