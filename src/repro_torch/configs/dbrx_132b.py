"""dbrx-132b [moe]: 40L d=6144 48H (GQA kv=8) ff=10752 vocab=100352, 16e top-4.

Fine-grained MoE, 16 experts top-4: expert-parallel over a 16-way model
axis, one expert a shard (port of ``repro.configs.dbrx_132b``).  Full
attention, so the dry-run skips ``long_500k``.
"""

from repro_torch.models.moe import MoEConfig

ID = "dbrx-132b"
FAMILY = "moe"
LONG_CONTEXT_OK = False


def config() -> MoEConfig:
    return MoEConfig(
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
        vocab=100_352, head_dim=128, n_experts=16, top_k=4,
    )


def smoke_config() -> MoEConfig:
    return MoEConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab=512, head_dim=16, n_experts=4, top_k=2, capacity_factor=8.0,
    )
