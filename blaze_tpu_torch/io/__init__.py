"""Scan IO: the object-store seam."""
