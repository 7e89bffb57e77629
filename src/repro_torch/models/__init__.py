"""Model families of the port (the dense decoder and the mixture of
experts), its registry, and the conversion of the JAX package's
parameters."""
