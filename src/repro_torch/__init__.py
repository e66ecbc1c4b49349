"""repro_torch: the PyTorch/CUDA port of the approximate-multiplier
reproduction (the JAX package ``repro`` is its reference). Entry points run
on the card unless the caller passes ``device="cpu"``."""
__version__ = "0.1.0"
