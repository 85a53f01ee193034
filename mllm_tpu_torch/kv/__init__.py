"""KV caches."""
