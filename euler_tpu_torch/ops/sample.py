"""Global sampling ops on the host (counterpart of
``euler_tpu/ops/sample.py``): thin functions over the engine client. The
device draws are ``graph/device.py``'s ``sample_node`` and
``sample_node_with_src``."""


def sample_node(g, count, node_type=-1):
    return g.sample_node(count, node_type)


def sample_edge(g, count, edge_type=-1):
    return g.sample_edge(count, edge_type)


def sample_node_with_src(g, src_nodes, count):
    """[n, count] negatives drawn from each src node's type distribution."""
    return g.sample_node_with_src(src_nodes, count)
