"""Output caches."""
