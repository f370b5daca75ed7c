"""The seeded synthetic token pipeline (``pipeline``), the port's copy of
the JAX package's ``repro.data``."""
