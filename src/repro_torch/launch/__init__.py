"""Command-line launchers and step functions of the port (serving and
LM training)."""
