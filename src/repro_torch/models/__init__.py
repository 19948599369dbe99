"""Model code of the port: attention and the dense transformer."""
