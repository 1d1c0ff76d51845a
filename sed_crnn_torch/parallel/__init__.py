"""Data- and seed-parallel training over process groups, one process per card."""
