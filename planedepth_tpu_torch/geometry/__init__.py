"""Plane geometry and camera constants."""
