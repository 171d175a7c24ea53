"""Training utilities of the port (so far the fault-tolerance helpers the
serving supervisor and server use)."""
