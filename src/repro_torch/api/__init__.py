"""Wire-format API: compressed payloads and FL/serve sessions (port of
``repro.api``).

  * :mod:`repro_torch.api.codecs`: the versioned binary payload codec, byte
    for byte the reference's for the ``omc`` and ``raw`` leaf kinds, full
    and delta.
  * :mod:`repro_torch.api.session`: ``FLSession`` (the server side: owns the
    compressed state, hands out per-round cohort payloads or async tickets,
    ingests client uploads, aggregates and re-compresses), ``FLClient`` (the
    loopback client) and ``ServeSession`` (batched decode over compressed
    weights with payload hot-swap).
  * ``python -m repro_torch.api.demo --smoke --device cpu``: a loopback
    download -> train -> upload -> aggregate driver over the whole wire path.
"""

from .codecs import (  # noqa: F401
    WIRE_VERSION,
    CodecError,
    PayloadInfo,
    decode_payload,
    encode_payload,
    negotiate_version,
    payload_bytes_report,
    peek_payload,
    register_leaf_codec,
    tree_digest,
)
from .session import (  # noqa: F401
    AsyncTicket,
    FLClient,
    FLSession,
    RoundTicket,
    ServeSession,
)

__all__ = [
    "CodecError",
    "PayloadInfo",
    "WIRE_VERSION",
    "decode_payload",
    "encode_payload",
    "negotiate_version",
    "payload_bytes_report",
    "peek_payload",
    "register_leaf_codec",
    "tree_digest",
    "AsyncTicket",
    "FLClient",
    "FLSession",
    "RoundTicket",
    "ServeSession",
]
