"""Serving: a render service over resident weights."""
