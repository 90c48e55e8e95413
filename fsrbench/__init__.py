"""The benchmark of ``fsr_tpu_torch`` on NVIDIA H100 cards (``run.py``).

Nothing here imports the program at import time, and the reference
(``fsrbench.reference``) never imports it.
"""
