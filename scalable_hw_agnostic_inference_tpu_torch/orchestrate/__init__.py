"""Fleet control-plane types the pod shares with the failover controller."""
