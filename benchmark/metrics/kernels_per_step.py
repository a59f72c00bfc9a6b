"""Kernels a step: the kernel nodes of the cell's one captured graph
(`CountedGraph.nodes`, counted once at its capture), over the graph's
steps.  Read for `.still` and `.video` alike."""


def read(lay: dict):
    graphs = lay.get("graphs", [])
    if len(graphs) != 1:
        return None
    nodes = getattr(graphs[0], "nodes", None)
    if not nodes or not nodes.get("kernel"):
        return None
    n, per = nodes["kernel"], lay["steps_per_graph"]
    return n // per if n % per == 0 else n / per
