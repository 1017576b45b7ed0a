"""Failure recovery.  Counterpart of casualhdrsplat_tpu/parallel/
distributed.py, its `resume_or_start` only: periodic checkpoints
(train/checkpoint.py) and an idempotent restart from the latest one.

`initialize`, the reference's multi-host start-up through
`jax.distributed`, waits for the multi-device slice (ROADMAP.md queue A,
`parallel/`).
"""

from __future__ import annotations

from casualhdrsplat_torch.train import checkpoint as ckpt_mod


def resume_or_start(trainer, ckpt_root: str) -> int:
    """Restore the latest checkpoint under `ckpt_root` if one exists.

    Returns the step resumed from (0 for a fresh start).  With periodic
    `trainer.save`, a crashed or preempted job restarted with the same
    command recovers to its last checkpoint."""
    latest = ckpt_mod.latest_step_dir(ckpt_root)
    if latest is None:
        return 0
    trainer.load(latest)
    return trainer.step
