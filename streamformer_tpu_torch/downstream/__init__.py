"""Streaming consumers of the encoder in downstream models."""
