"""The "train" kind: `Trainer.run_step` back to back from a resumed
state.  Set-up runs the compared steps first (the first of the window's
own calls, on different frames), then on until the mix's number of
density-control rounds has run, so that every graph the window replays
is captured; the reference follows the compared steps."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import scene
from benchmark.counts import work as work_mod
from benchmark.loops import BaseLoop, free, peak_bytes, sync
from benchmark.reference import train as ref_train


def train_indices(frames: int, eval_every: int) -> np.ndarray:
    """The frames a trainer trains on: all but every eval_every-th."""
    idx = np.arange(frames)
    return np.setdiff1d(idx, idx[::eval_every]) if eval_every > 0 else idx


def trainer_seed(seed: int, frames: np.ndarray, distinct: int) -> int:
    """The config seed, from the run's, whose frame sampler (numpy's
    default_rng(seed + 2), one choice a step) draws `distinct` different
    frames first: the compared steps then see different rows."""
    s = seed
    while True:
        rng = np.random.default_rng(s + 2)
        if len({int(rng.choice(frames)) for _ in range(distinct)}) == distinct:
            return s
        s += 1


class FrameSampler:
    """The trainer's frame sequence, drawn again by the benchmark."""

    def __init__(self, seed: int, frames: np.ndarray):
        self._rng = np.random.default_rng(seed + 2)
        self._frames = frames
        self.drawn: List[int] = []

    def next(self) -> int:
        self.drawn.append(int(self._rng.choice(self._frames)))
        return self.drawn[-1]


def leaf_norms(tree_get, names) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(tree_get(k).float())) for k in names}


class Loop(BaseLoop):
    """The training steps of a cell."""

    def setup(self) -> None:
        tr = self.traffic
        self.phase("start")
        points_rgb = self._inputs(render_video=True)
        self.phase("inputs")
        frames = train_indices(self.spec_scene["frames"], self.cfg_dict["data"]["eval_every"])
        self.config_seed = trainer_seed(self.seed, frames, tr["compared_steps"])
        self.sampler = FrameSampler(self.config_seed, frames)
        self.trainer = self._trainer(points_rgb, self.config_seed)
        self.phase("trainer")
        self._load(tr["resume_step"], moments=True)
        t = self.trainer
        names = [ref_train.leaf_name(p) for p, _ in ref_train.LEAVES]
        groups = dict((ref_train.leaf_name(p), g) for p, g in ref_train.LEAVES)
        self.program = {"loss": [], "frames": []}
        for i in range(tr["compared_steps"]):
            out = t.run_step()
            self.program["loss"].append(out["loss"])
            self.program["frames"].append(self.sampler.next())
            self.counters.update(dropped=int(out["dropped"]), clipped=int(out["clipped"]))
            if i == 0:
                # the first gradient as Adam got it: mu = (1 - b1) g from mu = 0
                scale = {k: 1.0 - ref_train._b1(self.cfg_dict, groups[k]) for k in names}
                mu = {k: ref_train.get(t.opt_state["mu"], k.split(".")) for k in names}
                self.program["grad"] = {k: float(torch.linalg.norm(mu[k])) / scale[k]
                                        for k in names}
                self.program["grads"] = {k: (mu[k] / scale[k]).cpu() for k in names}
        self.phase("compared_steps")
        self.program["change"] = leaf_norms(
            lambda k: ref_train.get(t.params, k.split("."))
            - ref_train.get(self.host["params"], k.split(".")).to(self.device), names)
        interval = self.cfg_dict["densify"]["interval"]
        last_round = (tr["resume_step"] // interval + tr["setup_rounds"]) * interval
        while t.step < last_round:
            out = t.run_step()
            self.sampler.next()
            if "pruned" in out:
                self.counters["pruned"] = self.counters.get("pruned", 0) + int(out["pruned"])
        self.counters["setup_steps"] = t.step - tr["resume_step"]
        self.phase("graph_steps")

    def window(self, seconds: float) -> dict:
        t = self.trainer
        steps = 0
        sync(self.device)
        t0 = last = time.perf_counter()
        walls = []
        while True:
            t.run_step()
            self.sampler.next()
            steps += 1
            now = time.perf_counter()
            walls.append(now - last)
            last = now
            if now - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        m = self.model
        pixels = self.spec_scene["size"] ** 2 * m["num_virtual_views"]
        self.attempted = steps
        return {"train_mpix_s": steps * pixels / elapsed / 1e6,
                "train_peak_gib": peak_bytes(self.device) / 2 ** 30,
                "_window_s": elapsed, "_steps": steps,
                "_step_ms_p10_p50_p90": [float(np.percentile(walls, q)) * 1e3
                                         for q in (10, 50, 90)]}

    def traced_slice(self, profile) -> dict:
        """Profile the mix's number of steps; what the readers need to count
        their work: the state before the slice and each step's frame."""
        t = self.trainer
        n = self.traffic["trace_steps"]
        state = scene.to_device(scene.clone_tree(t.params), "cpu")
        first = len(self.sampler.drawn)
        with profile() as p:
            for _ in range(n):
                with torch.profiler.record_function("bench.step"):
                    t.run_step()
                self.sampler.next()
        self.attempted = n
        frames = self.sampler.drawn[first:first + n]
        return {"trace": p, "units": n, "kind": "train",
                "work": lambda: work_mod.train_work(state, self.ref_scene(), frames, self.model,
                                                     t.active_sh_degree())}

    def release(self) -> None:
        self.trainer = None
        free(self.device)

    def reference(self, tf32: bool = False, views: Optional[int] = None) -> dict:
        """The reference's compared steps from the same state on the same
        frames: each step's loss, the norms of the first gradient's and of
        the parameters' change over the steps, leaf by leaf.  With `tf32`
        its matrix products and convolutions run in TF32 (the control);
        `views` blurs a frame over only the first so many virtual views
        (a planted fault)."""
        from benchmark import compare

        host = self.host
        cfg = self.cfg_dict
        if views is not None:
            cfg = {**cfg, "model": {**cfg["model"], "blur_views": views}}
        with compare.matmul_precision(tf32):
            rt = ref_train.Trainer(
                scene.to_device(host["params"], self.device),
                scene.to_device(host["mu"], self.device), scene.to_device(host["nu"], self.device),
                self.ref_scene(), torch.as_tensor(self.video.images, device=self.device),
                ref_train.exposure_init(self.spec_scene["frames"], self.device), cfg,
                ref_train.scene_extent(self.points), self.traffic["resume_step"],
                self.traffic["resume_step"])
            losses, grad, rms = [], None, None
            for i, frame in enumerate(self.program["frames"]):
                loss, grads = rt.run_step(frame)
                losses.append(loss)
                if i == 0:
                    grad = {k: float(torch.linalg.norm(v)) for k, v in grads.items()}
                    # the size of a moving element's gradient (the state's
                    # second moments are drawn at this scale)
                    rms = {k: float(v[v != 0].square().mean().sqrt()) if bool((v != 0).any())
                           else 0.0 for k, v in grads.items()}
                    first = {k: v.detach().cpu() for k, v in grads.items()}
                del grads
            change = leaf_norms(
                lambda k: ref_train.get(rt.params, k.split("."))
                - ref_train.get(host["params"], k.split(".")).to(self.device), list(grad))
        del rt
        free(self.device)
        return {"loss": losses, "grad": grad, "change": change, "rms": rms, "grads": first}

    def readings(self, reference: Optional[dict] = None) -> dict:
        """The gaps of the program's numbers to the reference's."""
        from benchmark import compare

        reference = reference or self.reference()
        out = compare.train_gaps(self.program, reference)
        out["_grad_rms"] = reference["rms"]
        return out

    def control_readings(self, reference: dict) -> dict:
        """The gaps of the reference in TF32, put in the program's place."""
        from benchmark import compare

        return compare.train_gaps(self.reference(tf32=True), reference)
