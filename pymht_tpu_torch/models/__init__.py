"""State-space models of the port (constant-velocity radar, AIS)."""
