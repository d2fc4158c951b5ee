"""Sparse (supermask) training: port of ``dsgcn_tpu/sparse/``."""
