"""Checkpoint loading and synthetic sequences."""
