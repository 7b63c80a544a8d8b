"""Profiling entry points of the port, counterparts of the JAX package's
``tools/profile_*.py``: each splits one part of the system into timed
rows. Run as ``python -m dynamicfusion_body_tpu_torch.tools.<name>``
(``--device cpu --res 32`` for a small CPU run)."""
