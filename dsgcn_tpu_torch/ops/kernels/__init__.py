"""The port's hand-written CUDA kernels (``csrc``), their wrappers and
plain PyTorch versions.  Each kernel is a ``torch.library`` custom op
(namespace ``dsgcn``), registered when its module is imported; the kernel
is built at its first CUDA call.  Each wrapper counts the kernels it
launches in its ``launches`` attribute, inside the op's CUDA
implementation (so launches from an exported program count too);
:func:`launch_counts` reads them all."""


def wrappers():
    """Every kernel wrapper of the port (K3, K1, K2, K4, K5, K6, K7); the
    first call registers the ops."""
    from .bd_agg import bd_dyn_graph_agg, bd_dyn_graph_agg_subset
    from .dggcn_block import fused_dggcn_block_eval
    from .dyn_graph import (fused_dyn_graph_agg, fused_dyn_graph_agg_bwd,
                            fused_dyn_graph_agg_eval)
    from .ms_tcn import fused_dgmstcn_eval
    return (bd_dyn_graph_agg, fused_dyn_graph_agg, fused_dyn_graph_agg_bwd,
            bd_dyn_graph_agg_subset, fused_dyn_graph_agg_eval,
            fused_dggcn_block_eval, fused_dgmstcn_eval)


def launch_counts():
    """{wrapper name: kernel launches so far} of this process."""
    return {w.__name__: w.launches for w in wrappers()}
