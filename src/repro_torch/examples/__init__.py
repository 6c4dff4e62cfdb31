"""Runnable examples of the port, each a copy of one under the JAX
package's ``examples/`` (run with ``python -m repro_torch.examples.<name>``)."""
