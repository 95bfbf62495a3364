"""Configuration dataclasses of the port (a copy of the reference's), and
its span tracer (`tracing`)."""
