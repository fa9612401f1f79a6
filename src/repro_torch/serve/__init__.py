"""Serving layer: the SeCluD search service on one device."""
