"""Paged-KV continuous-batching engine (lock-step, one device, bf16)."""
