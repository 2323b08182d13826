"""xLSTM-350M — sLSTM + mLSTM recurrent blocks (attention-free), as in
``repro.configs.xlstm_350m``.

arXiv:2405.04517: 24 layers, d_model 1024, 4 heads, vocab 50304; the block
pattern xLSTM[7:1] (seven mLSTM blocks, then one sLSTM block, a period).
d_ff 0: the blocks carry their own up/down projections (pf = 2 for mLSTM,
4/3 for sLSTM) instead of a separate MLP.  No weights ship with the port:
the model is initialized from a seed.
"""

from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="xlstm_350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    norm="layernorm",
    rope="none",
    sub_quadratic=True,
)

SMOKE_CONFIG = reduced(CONFIG, num_layers=8, d_ff=0)
