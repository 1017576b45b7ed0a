"""entry.dryrun_multichip, the port's counterpart of the reference's
`__graft_entry__.dryrun_multichip`, on four gloo ranks in CPU processes: a
(2, 2) mesh, 3 training steps of the packed path through a densify round,
then a rebalance of the store.  The function asserts what the reference
asserts (finite loss, the store grew, the rebalance kept the count and did
not widen the spread); the test checks what it returns."""

import numpy as np

from casualhdrsplat_torch import entry


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    results = entry.dryrun_multichip(4, device="cpu")
    line = capsys.readouterr().out
    assert line.startswith("dryrun_multichip ok: mesh={'data': 2, 'gauss': 2}"), line
    assert len(results) == 4
    r = results[0]
    assert all(x["loss"] == r["loss"] and x["after"] == r["after"] for x in results)
    assert np.isfinite(r["loss"]) and r["alive"] > r["alive0"]
    assert sum(r["after"]) == sum(r["before"])
    assert max(r["after"]) - min(r["after"]) <= 1
    assert r["block"] == (128, 3)
    # the step's collectives ran, their gradient rules among them
    assert {"payload", "payload.grad", "images", "store.grad", "densify_report"} <= set(
        r["collectives"])
