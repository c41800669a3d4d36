"""The port's measuring entry points beside its benchmark (counterparts of
the repository's scripts/round8.py and scripts/scaling.py)."""
