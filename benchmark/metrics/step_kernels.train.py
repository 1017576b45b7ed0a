"""The kernel nodes of the captured training step's graph: the launches
every replay of the step makes, counted by the program at capture
(casualhdrsplat_torch/utils/cuda_graphs.py `GRAPH_NODES`, the latest capture
of the graph named "the training step ..."), read in this process.  Nothing
to read outside a train slice or where the program keeps no such count."""

STEP = "the training step"


def read(t):
    if t.kind != "train":
        return None
    from casualhdrsplat_torch.utils import cuda_graphs

    nodes = [n for name, n in getattr(cuda_graphs, "GRAPH_NODES", {}).items()
             if name.startswith(STEP)]
    return float(nodes[-1]) if nodes else None
