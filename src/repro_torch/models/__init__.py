"""Model families of the port (the dense decoder so far), its registry,
and the conversion of the JAX package's parameters."""
