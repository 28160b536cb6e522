"""Shape bucketing and device resolution."""
