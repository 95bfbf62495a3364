"""Configuration dataclasses of the port (a copy of the reference's)."""
