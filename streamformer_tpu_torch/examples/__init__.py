"""Runnable walkthroughs of the port: ``python -m streamformer_tpu_torch.examples.<name>``."""
