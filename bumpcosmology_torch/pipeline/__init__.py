"""The pipeline stages of the port (L4/L6); the joint fit stage so far."""
