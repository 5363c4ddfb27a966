"""Map-point to frame matching."""
