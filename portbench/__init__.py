"""The port's benchmark: cells of a configuration under a traffic mix,
run by ``run.py``."""
