"""Tarragon's resilience core: ERT, REFE routing, shadows, self-healing."""
