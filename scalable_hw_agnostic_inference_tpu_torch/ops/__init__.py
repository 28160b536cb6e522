"""Tensor ops: attention dispatch, rope, norms, projections, sampling."""
