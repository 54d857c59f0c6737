"""WAV decode and encode (numpy only)."""
