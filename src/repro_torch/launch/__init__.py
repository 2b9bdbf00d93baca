"""Entry points of the port (the serving entry point in this slice)."""
