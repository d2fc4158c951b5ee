"""Data-parallel and joint-partitioned training of the port over
``torch.distributed`` (``mesh``, ``joint_partition``, ``train``)."""
