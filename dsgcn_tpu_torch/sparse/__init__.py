"""Sparse (supermask) training: port of ``dsgcn_tpu/sparse/``."""
from .models import SparseCTRGCN, SparseSTGCN, SparseSTGCNExact
from .nested import (AssembleSparse, SparseAAGCN, SparseDGSTGCN,
                     assemble_regularize)
from .smoe import (NoisyTopKGate, SMoEAssembleSparse, cv_squared,
                   smoe_regularize)
from .supermask import (get_sparsity, group_lasso_penalty,
                        make_sparse_optimizer, rerandomize_tree,
                        sparsity_schedule, supermask, supermask_at)

__all__ = ["SparseCTRGCN", "SparseSTGCN", "SparseSTGCNExact", "SparseAAGCN",
           "SparseDGSTGCN", "AssembleSparse", "assemble_regularize",
           "NoisyTopKGate", "SMoEAssembleSparse", "cv_squared",
           "smoe_regularize", "get_sparsity", "group_lasso_penalty",
           "make_sparse_optimizer", "rerandomize_tree", "sparsity_schedule",
           "supermask", "supermask_at"]
