"""Distributed-optimization pieces of the port (the counterpart of
``repro.parallel``): posit8 gradient compression with error feedback."""
