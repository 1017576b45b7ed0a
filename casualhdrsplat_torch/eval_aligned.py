"""Pose-aligned deblurred-render evaluation of a quality-run checkpoint.
Counterpart of the reference's `scripts/eval_aligned.py`:

    python -m casualhdrsplat_torch.eval_aligned --out <report> --render-dir <dir>

Loads the newest checkpoint under `<render-dir>/ckpt` with the fixture
knobs and config the quality run kept beside it, rebuilds the same
fixture (deterministic, cached), and scores the deblurred renders of the
train frames against the sharp ground truth, raw and after test-time pose
alignment (quality_run.aligned_block), saving the aligned renders.  The
result goes into the report under `final_eval_aligned` /
`deblurring_gain_db_aligned`.  Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from casualhdrsplat_torch import config
from casualhdrsplat_torch import quality_run
from casualhdrsplat_torch.parallel.distributed import resume_or_start
from casualhdrsplat_torch.train.trainer import Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "quality",
                                                  "QUALITY_torch.json"))
    ap.add_argument("--render-dir", default=os.path.join("chiprun_out", "quality"))
    ap.add_argument("--fixture-cache", default=os.path.join("outputs", "fixture_cache"))
    ap.add_argument("--steps", type=int, default=64, help="alignment Adam steps per frame")
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("eval_aligned: no CUDA device; pass --device cpu for a CPU run",
              file=sys.stderr)
        return 2

    ckpt_root = os.path.abspath(os.path.join(args.render_dir, "ckpt"))
    with open(os.path.join(ckpt_root, "fixture.json")) as f:
        knobs = json.load(f)
    with open(os.path.join(ckpt_root, "config.json")) as f:
        cfg = config.from_dict(json.load(f))
    print("rebuilding fixture (cached)...", flush=True)
    _, ds = quality_run.build_fixture(knobs, args.device, args.fixture_cache)
    t = Trainer(cfg, ds, device=args.device)
    step = resume_or_start(t, ckpt_root)
    if step == 0:
        raise SystemExit(f"no checkpoint under {ckpt_root}")
    print(f"checkpoint at step {step}", flush=True)

    tr = list(t.dataset.train_indices)
    eval_idx = [tr[i] for i in range(0, len(tr), max(1, len(tr) // 6))]
    t0 = time.time()
    block = quality_run.aligned_block(t, eval_idx, args.steps, args.lr,
                                      save_dir=args.render_dir)
    block["wall_s"] = round(time.time() - t0, 1)
    gain = quality_run.merge_aligned(args.out, block)
    print(f"aligned gain {gain:+.2f} dB (raw {block['eval_sharp_psnr_raw']:.2f} -> aligned "
          f"{block['eval_sharp_psnr_aligned']:.2f} vs input "
          f"{block['eval_sharp_psnr_input']:.2f}); merged into {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
