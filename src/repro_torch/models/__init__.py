"""CNN layer vocabulary and parameters."""
