"""Model families of the port (dense transformer so far)."""
