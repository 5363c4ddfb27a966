"""Fiducial markers: the ArUco dictionaries, the native detector, IPPE."""
