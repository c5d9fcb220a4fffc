"""internvl2-1b [vlm]: 24L d=896 14H (GQA kv=2) ff=4864 vocab=151808.

InternViT frontend + Qwen2-0.5B LM backbone (port of
``repro.configs.internvl2_1b``).  The ViT is a stub: 1024 precomputed patch
embeddings (``batch["patches"]``) are prepended to the token stream
(``prefix_embeds``).  Full attention, so the dry-run skips ``long_500k``.

The full config's fields are the reference's as it evaluates them: there
a comment on the ``vocab`` line swallows ``head_dim=64, qkv_bias=True,
tie_embeddings=True``, so the full model has no QKV bias and an untied
head (head_dim is d_model / n_heads = 64 either way); the smoke config
keeps all three (ROADMAP C28).
"""

from repro_torch.models.transformer import TransformerConfig

ID = "internvl2-1b"
FAMILY = "vlm"
LONG_CONTEXT_OK = False
N_PATCHES = 1024


def config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
        vocab=151_808,  # padded from 151655 to a 256-multiple (embedding sharding)
        prefix_embeds=N_PATCHES,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, d_ff=128,
        vocab=512, head_dim=8, qkv_bias=True, tie_embeddings=True,
        prefix_embeds=8,
    )
