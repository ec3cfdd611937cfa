"""Integrators (BDPT)."""
