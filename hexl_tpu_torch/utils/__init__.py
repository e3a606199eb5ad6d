"""Utilities of the port (this slice: the debug validation of `check`)."""
