"""Measurement tools of the port, each run as ``python -m
rufus_tpu_torch.tools.<name>``."""
