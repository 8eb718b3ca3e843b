"""Storage backends, copied from ``simpletuner_tpu/data/backends``."""
