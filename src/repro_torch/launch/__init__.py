"""Launch-side fixtures of the port."""
