"""Model definitions of the port (the llama family)."""
