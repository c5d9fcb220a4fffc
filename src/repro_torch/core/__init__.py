"""OMC codec: formats, PVT, policy, PPQ, packing, storage, and the threefry
PRNG the reference's streams come from (port of ``repro.core``)."""
