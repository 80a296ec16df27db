"""Simulated sidereal and time streams."""
