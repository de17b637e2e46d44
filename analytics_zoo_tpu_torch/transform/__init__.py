"""Transforms of the port; only the audio chain so far."""
