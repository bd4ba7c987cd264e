"""Kernel probes: each measures one part of a kernel's work on the card,
against a plain torch version of the same function."""
