"""xlstm-350m [ssm]: 24L d=1024 4H d_ff=0 vocab=50304 — sLSTM + mLSTM blocks.

xLSTM[7:1] ratio (1 in 8 blocks sLSTM): 3 super blocks of 7 mLSTM blocks
and 1 sLSTM block.  A constant-size recurrent state, so ``long_500k`` runs
(port of ``repro.configs.xlstm_350m``; arXiv:2405.04517).  The init holds
467,347,624 parameters; the reference's ``param_count`` formula, kept,
says 467,368,960 (ROADMAP C29).
"""

from repro_torch.models.xlstm import XLSTMConfig

ID = "xlstm-350m"
FAMILY = "xlstm"
LONG_CONTEXT_OK = True


def config() -> XLSTMConfig:
    return XLSTMConfig(
        n_layers=24, d_model=1024, n_heads=4, vocab=50_304, slstm_every=8,
    )


def smoke_config() -> XLSTMConfig:
    return XLSTMConfig(
        n_layers=5, d_model=32, n_heads=2, vocab=256, slstm_every=2,
    )
