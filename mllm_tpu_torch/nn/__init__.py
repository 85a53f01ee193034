"""Layers and attention."""
