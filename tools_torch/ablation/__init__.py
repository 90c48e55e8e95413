"""H100 counterparts of ``tools/ablation``: the probes of K1's op mix, the FMA
rate and float16 (kernels P1-P4, ``fsr_tpu_torch/kernels/probes.py``)."""
