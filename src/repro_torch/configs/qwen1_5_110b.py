"""qwen1.5-110b [dense]: 80L d=8192 64H (GQA kv=8) ff=49152 vocab=152064.

QKV bias, untied head (port of ``repro.configs.qwen1_5_110b``).  Full
attention, so the dry-run skips ``long_500k``.
"""

from repro_torch.models.transformer import TransformerConfig

ID = "qwen1.5-110b"
FAMILY = "transformer"
LONG_CONTEXT_OK = False


def config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=49152,
        vocab=152_064, head_dim=128, qkv_bias=True,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=192,
        vocab=512, head_dim=8, qkv_bias=True,
    )
