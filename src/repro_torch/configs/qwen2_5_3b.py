"""qwen2.5-3b [dense]: 36L d=2048 16H (GQA kv=2) ff=11008 vocab=151936.

GQA with QKV bias, RoPE, tied embeddings (port of ``repro.configs.qwen2_5_3b``).
Full attention, so the dry-run skips ``long_500k``.
"""

from repro_torch.models.transformer import TransformerConfig

ID = "qwen2.5-3b"
FAMILY = "transformer"
LONG_CONTEXT_OK = False


def config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
        vocab=151_936, head_dim=128, qkv_bias=True, tie_embeddings=True,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab=512, head_dim=16, qkv_bias=True, tie_embeddings=True,
    )
