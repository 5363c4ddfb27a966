"""Tracking and the system state machine."""
