"""Tensor parallelism: the sharding rules over state-dict names, the
loopback group that runs a model's ranks as threads of one process, and
the ``torch.distributed`` group that runs them as processes."""
