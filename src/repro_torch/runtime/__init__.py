"""Causal-gossip training (``gossip``): the paper's PC-broadcast as the
control plane of DiLoCo-style training across pods."""
