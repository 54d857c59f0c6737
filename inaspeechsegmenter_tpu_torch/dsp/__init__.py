"""Feature frontend and patch extraction."""
