"""Measurements of the port on the card that are run by hand, not by the
smoke test."""
