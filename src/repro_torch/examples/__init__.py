"""Runnable examples of the port (``python -m repro_torch.examples.failover_demo``)."""
