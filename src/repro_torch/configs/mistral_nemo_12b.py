"""mistral-nemo-12b [dense]: 40L d=5120 32H (GQA kv=8) ff=14336 vocab=131072.

128k-context full attention, head_dim 128, so the projection width 4096 is
not d_model (port of ``repro.configs.mistral_nemo_12b``).  Full attention,
so the dry-run skips ``long_500k``.
"""

from repro_torch.models.transformer import TransformerConfig

ID = "mistral-nemo-12b"
FAMILY = "transformer"
LONG_CONTEXT_OK = False


def config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab=131_072, head_dim=128, rope_theta=1_000_000.0,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=96, n_heads=4, n_kv_heads=2, d_ff=192,
        vocab=512, head_dim=16,
    )
