"""H100 counterparts of the JAX package's tools (``tools/``); scripts, run from the
root of a checkout."""
