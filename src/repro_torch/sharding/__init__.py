"""Partition rules for the LM stack (``rules``)."""
