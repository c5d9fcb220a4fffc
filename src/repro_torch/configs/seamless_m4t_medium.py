"""seamless-m4t-medium [audio]: 12+12L d=1024 16H (MHA kv=16) ff=4096 vocab=256256.

Encoder-decoder; the audio frontend is a stub (the batch carries
precomputed frame embeddings).  Decoder length = seq_len // 4 (port of
``repro.configs.seamless_m4t_medium``; arXiv:2308.11596).  Full attention,
so ``long_500k`` is skipped.  In the reference's config a comment swallows
``dec_ratio=4``; the default is 4, so nothing changes (ROADMAP C28).  The
init holds 877,383,680 parameters; the reference's ``param_count``
formula, kept, says 877,381,632 (ROADMAP C29).
"""

from repro_torch.models.encdec import EncDecConfig

ID = "seamless-m4t-medium"
FAMILY = "encdec"
LONG_CONTEXT_OK = False


def config() -> EncDecConfig:
    return EncDecConfig(
        n_enc_layers=12, n_dec_layers=12, d_model=1024, n_heads=16,
        n_kv_heads=16, d_ff=4096,
        vocab=256_256,  # 256,206 padded to a multiple of 256, as in the reference
    )


def smoke_config() -> EncDecConfig:
    return EncDecConfig(
        n_enc_layers=2, n_dec_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=512, dec_ratio=4,
    )
