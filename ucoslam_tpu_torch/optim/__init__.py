"""Pose refinement."""
