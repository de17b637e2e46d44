"""Transforms of the port: the audio chain and the vision transforms."""
