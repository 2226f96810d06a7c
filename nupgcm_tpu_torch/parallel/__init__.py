"""Domain decomposition over a shard group (``comm.ShardGroup``,
``dd.DDModel``): the counterpart of ``nupgcm_tpu.parallel``'s
device-mesh axis and sharded-state model."""
