"""Frame and map state."""
