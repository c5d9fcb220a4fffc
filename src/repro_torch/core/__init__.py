"""OMC codec: formats, PVT, policy, packing, storage (port of ``repro.core``)."""
