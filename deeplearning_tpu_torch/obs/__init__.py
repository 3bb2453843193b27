"""Observability of the port: host span tracer, flight recorder and the
thread spawn registry (copies of the JAX package's, with
``torch.profiler`` in place of ``jax.profiler``)."""
