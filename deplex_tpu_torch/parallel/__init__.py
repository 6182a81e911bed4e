"""Batches and ranks: frame-batched extraction (``batch``), the
torch.distributed layer (``distributed``: initialize, meshes, collectives),
the local launcher and its verification worker (``launcher``, ``verify``)
and the host-side PNG prefetcher (``prefetch``)."""
