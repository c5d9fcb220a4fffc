"""conformer_s — the paper's streaming Conformer (§3.1), port of
``repro.configs.conformer_s``: 17L d=512 8H ff=2048, 1024 classes, 80-dim
frames, conv kernel 32, attention window 128 (103,535,104 parameters)."""

from repro_torch.models.conformer import ConformerConfig

ID = "conformer_s"
FAMILY = "conformer"
LONG_CONTEXT_OK = False


def config() -> ConformerConfig:
    return ConformerConfig(
        n_layers=17, d_model=512, n_heads=8, d_ff=2048, n_classes=1024,
        d_in=80, conv_kernel=32, window=128, causal_conv=True,
    )


def smoke_config() -> ConformerConfig:
    """CPU-benchmark scale (the reference's paper-table reproductions)."""
    return ConformerConfig(
        n_layers=2, d_model=48, n_heads=4, d_ff=96, n_classes=32,
        d_in=16, conv_kernel=4, window=16, causal_conv=True,
    )
