"""Roofline accounting for the port on NVIDIA H100 cards."""
