"""Plain float32 references the port is held to."""
