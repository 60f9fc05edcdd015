"""Measurement tools that run the port on the card."""
