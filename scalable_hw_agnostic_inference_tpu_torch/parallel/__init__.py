"""Tensor parallelism: the sharding rules over state-dict names and the
loopback group that runs a model's ranks as threads of one process."""
