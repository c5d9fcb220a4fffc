"""recurrentgemma-2b [hybrid]: 26L d=2560 10H (MQA kv=1) ff=7680 vocab=256000.

RG-LRU + local attention in a (rec, rec, attn) 1:2 pattern; window 2048;
2,894,528,000 parameters (port of ``repro.configs.recurrentgemma_2b``;
arXiv:2402.19427).
"""

from repro_torch.models.griffin import GriffinConfig

ID = "recurrentgemma-2b"
FAMILY = "griffin"
LONG_CONTEXT_OK = True


def config() -> GriffinConfig:
    return GriffinConfig(
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
        vocab=256_000, lru_width=2560, window=2048, pattern_period=3,
    )


def smoke_config() -> GriffinConfig:
    return GriffinConfig(
        n_layers=5, d_model=40, n_heads=2, n_kv_heads=1, d_ff=96,
        vocab=256, lru_width=40, window=16, pattern_period=3,
    )
