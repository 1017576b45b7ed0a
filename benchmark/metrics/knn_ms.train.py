"""The start-up k-NN's host time (ms): the program's record of the last
`knn_mean_dist` call this process made (casualhdrsplat_torch/ops/knn.py
`LAST`: points, route, and the host clock from the search's start to the
result on the device, after a sync), read in this process after the slice.
In a train slice that call is the one that built the trainer, since the
harness builds one trainer and nothing after it calls the k-NN.  Nothing to
read outside a train slice or where the program keeps no such record."""


def read(t):
    if t.kind != "train":
        return None
    from casualhdrsplat_torch.ops import knn

    last = getattr(knn, "LAST", None)
    ms = getattr(last, "ms", None)
    return None if ms is None else float(ms)
