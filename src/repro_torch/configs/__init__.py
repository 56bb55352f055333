"""Model configurations of the port (EMSNet only, so far)."""
