"""Engine step telemetry."""
