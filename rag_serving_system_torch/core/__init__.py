"""Serving engine and batch processor."""
