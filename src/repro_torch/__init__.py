"""PyTorch/CUDA port of the Tarragon reproduction (``repro``).

Mirrors the JAX package module for module. Imports torch and numpy only;
entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
