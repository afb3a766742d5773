"""Tools of the port (counterparts of the repository's tools/ scripts)."""
