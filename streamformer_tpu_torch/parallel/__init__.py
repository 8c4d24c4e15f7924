"""Losses that span the data-parallel group; single-process forms for now."""
