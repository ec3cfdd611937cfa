"""Render driver."""
