"""Examples of the PyTorch/CUDA port (``fsr_tpu_torch``)."""
