"""Runnable examples of the port, each the twin of a script of the JAX
package's ``examples/`` directory:
``python -m repro_torch.examples.<name>``."""
