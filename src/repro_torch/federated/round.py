"""Serve functions over compressed weights (port of ``repro.federated.round``).

Only ``make_serve_fns`` is ported; the training round belongs to the
training slice.
"""

from __future__ import annotations

from .materialize import OMCMaterializer


def make_serve_fns(family, cfg):
    """(prefill_fn, decode_fn) over a storage tree — the serving path."""
    mat = OMCMaterializer()

    def prefill_fn(params, batch, cache):
        return family.prefill(cfg, params, batch, mat, cache)

    def decode_fn(params, cache, tokens):
        return family.decode_step(cfg, params, cache, tokens, mat)

    return prefill_fn, decode_fn
