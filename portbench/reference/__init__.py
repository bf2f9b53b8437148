"""The plain reference the served tokens are held to."""
