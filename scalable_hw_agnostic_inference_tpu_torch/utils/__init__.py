"""Environment contract and latency instruments."""
