"""Paged-KV continuous-batching engine (async and lock-step decode, on one
device or over tensor-parallel ranks: ``engine.ranks``)."""
