"""Paged-KV continuous-batching engine (async and lock-step decode, one
device)."""
