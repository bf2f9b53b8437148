"""Serving stack of the port: gateway, workers, scheduler, engine."""
