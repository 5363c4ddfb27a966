"""Checkpoint loading, synthetic sequences and stereo rectification."""
