"""The shm data plane: coworker processes push batches into a native
shared-memory ring (``shm_ring``), the trainer pops them and
``DevicePrefetch`` stages them to the GPU on a copy stream
(``shm_dataloader``); ``elastic_shm`` feeds the producers from the
master's data shards. The producer side (``shm_ring``,
``shm_dataloader`` at import, ``elastic_shm``, ``synth``) imports no
torch."""
