"""Communicator topologies — the ``ompi/mca/topo`` analogue."""

from .topo import (  # noqa: F401
    CartTopo, GraphTopo, DistGraphTopo, cart_create, graph_create,
    dist_graph_create_adjacent, dims_create,
)
