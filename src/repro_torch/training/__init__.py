"""Training: AdamW (``optimizer``), block-scaled int8 gradient compression
with error feedback (``compression``), atomic checkpoints (``checkpoint``),
restarts, the straggler watchdog and the heartbeat (``fault_tolerance``)
and the microbatched train step (``train_step``). The port of the JAX
package's ``training/``."""
