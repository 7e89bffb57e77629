"""The roofline of a sharded step on an H100 mesh: ``counter`` counts what
rank 0 runs (the counterpart of the JAX package's ``hlo_parser``),
``analysis`` prices it at the H100's published rates."""
