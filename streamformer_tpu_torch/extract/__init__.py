"""Per-frame feature extraction on the streaming encoder."""
