"""Data pipeline of the port (numpy copy of ``repro.data``)."""
