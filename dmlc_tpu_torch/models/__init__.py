"""Models of the port: the flagship decoder LM's serving forwards."""
