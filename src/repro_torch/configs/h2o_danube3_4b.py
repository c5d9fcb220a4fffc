"""h2o-danube-3-4b [dense]: 24L d=3840 32H (GQA kv=8) ff=10240 vocab=32000.

llama+mistral mix with sliding-window attention (window 4096, uniform)
(port of ``repro.configs.h2o_danube3_4b``).  The window bounds the decode
cache (a ring of 4096 slots), so the dry-run runs ``long_500k``.
"""

from repro_torch.models.transformer import TransformerConfig

ID = "h2o-danube-3-4b"
FAMILY = "transformer"
LONG_CONTEXT_OK = True


def config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_ff=10240,
        vocab=32_000, head_dim=120, window=4096,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab=512, head_dim=16, window=16,
    )
