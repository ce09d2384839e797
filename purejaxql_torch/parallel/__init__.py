"""The port's multi-GPU layer on ``torch.distributed``: process groups and
the (seed, env) mesh (``mesh.py``), the sharded trainers (``spmd.py``)."""
