"""The synthetic, deterministic, restartable data pipeline."""
