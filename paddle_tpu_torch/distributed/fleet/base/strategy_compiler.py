"""StrategyCompiler: pick and order the applicable meta-optimizers
(counterpart of paddle_tpu/distributed/fleet/base/strategy_compiler.py):
the chain of meta-optimizers that white-list each other, in the
canonical order, each wrapping the next's minimize."""

from __future__ import annotations


def maximum_path_len_algo(optimizer_list):
    """Reference algorithm: choose the longest mutually-compatible chain.
    Our chain is canonical-ordered, so compatibility reduces to each
    earlier opt white-listing each later one."""
    if not optimizer_list:
        return None
    chain = []
    for opt in optimizer_list:
        ok = all(opt.__class__.__name__ in prev.meta_optimizers_white_list
                 or not prev.meta_optimizers_white_list
                 for prev in chain)
        if ok:
            chain.append(opt)
    # wire them: each wraps the next's minimize
    for i in range(len(chain) - 1):
        chain[i].inner_opt = chain[i + 1]
    return chain


class StrategyCompiler:
    def __init__(self):
        self._meta_optimizers = []
        self._graph_optimizers = []

    def generate_optimizer(self, loss, role_maker, optimizer,
                           user_defined_strategy, meta_optimizers,
                           graph_optimizers):
        chain = maximum_path_len_algo(meta_optimizers)
        self._meta_optimizers = chain or []
        self._graph_optimizers = graph_optimizers or []
        return (user_defined_strategy,
                chain[0] if chain else None,
                self._graph_optimizers[0] if self._graph_optimizers else None)
