"""Loops that drive a system through one run's window, one module a
traffic mix's `driver`."""
