"""Samplers and generation loops."""
