"""Evaluation on the host: the VideoQA answer scorer and the numpy metrics."""
