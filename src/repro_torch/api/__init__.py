"""Public serving API of the port."""
