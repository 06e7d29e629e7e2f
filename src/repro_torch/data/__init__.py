"""Seeded dataset surrogates."""
