"""mixtral-8x7b [moe]: 32L d=4096 32H (GQA kv=8) ff=14336 vocab=32000, 8e top-2.

Sliding window 4096, so the dry-run runs ``long_500k`` (a ring-buffer KV)
(port of ``repro.configs.mixtral_8x7b``).  On a 16-way model axis each
expert is co-owned by 2 shards splitting the FFN dim (``ep_partitions=2``,
set by the launcher).
"""

from repro_torch.models.moe import MoEConfig

ID = "mixtral-8x7b"
FAMILY = "moe"
LONG_CONTEXT_OK = True


def config() -> MoEConfig:
    return MoEConfig(
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab=32_000, head_dim=128, n_experts=8, top_k=2, window=4096,
    )


def smoke_config() -> MoEConfig:
    return MoEConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab=512, head_dim=16, n_experts=4, top_k=2, capacity_factor=8.0, window=16,
    )
