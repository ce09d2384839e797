"""Grid worlds, batched: Forager, the craftax-class env."""
