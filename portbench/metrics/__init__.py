"""Per-layer metric readers, one file each, found by the metric's name."""
