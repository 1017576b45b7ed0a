"""What the benchmark's loops share, and the lookup of a loop by name.

A traffic mix (benchmark/traffic/<mix>.json) names its `kind`; the loop
of that kind is the class `Loop` of benchmark/kinds/<kind>.py, found by
that name (`load_kind`), so that a new kind of traffic is a new file.  A
loop drives the system under test (casualhdrsplat_torch): it makes its
inputs from the seed (benchmark/scene.py), builds the program's objects,
warms up every shape the window uses, runs the window, a traced slice,
and the comparison with the plain reference (benchmark/reference).

The program is imported inside the functions, after the harness has
checked the device, so that this module imports on any machine.
"""

from __future__ import annotations

import gc
import importlib.util
import time
from pathlib import Path
from typing import Dict

import torch

from benchmark import scene
from benchmark.reference import render as ref
from benchmark.reference import train as ref_train

ROOT = Path(__file__).resolve().parent.parent
_KINDS: Dict[Path, type] = {}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def peak_bytes(device: torch.device) -> int:
    """The most device memory PyTorch held since the last reset, graph pools
    included (reserved, not only allocated)."""
    return int(torch.cuda.max_memory_reserved(device)) if device.type == "cuda" else 0


def load_kind(kind: str, root: Path = ROOT) -> type:
    """The class `Loop` of benchmark/kinds/<kind>.py."""
    path = root / "benchmark" / "kinds" / f"{kind}.py"
    if path not in _KINDS:
        spec = importlib.util.spec_from_file_location(f"benchmark_kind_{kind.replace('.', '_')}",
                                                      path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _KINDS[path] = module.Loop
    return _KINDS[path]


class BaseLoop:
    """What the kinds share: the inputs, the program's config and
    trainer, the traced slice's bookkeeping."""

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg_dict = cell.config["config"]
        self.model = self.cfg_dict["model"]
        self.spec_scene = cell.config["assumed"]["scene"]
        self.spec_state = cell.config["assumed"]["state"]
        self.traffic = cell.traffic
        self.trainer = None
        self.counters: Dict[str, int] = {}
        self.phases: Dict[str, float] = {}
        self._clock = time.perf_counter()
        r = self.model["rasterize"]
        if r["antialias"] or r["backend"] == "xla" or self.model["white_background"]:
            raise ValueError("the reference follows antialias off, the kernels' backend and a "
                             "black background")

    def _inputs(self, render_video: bool):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        video = scene.make_video(gen, self.spec_scene, self.device, render=render_video)
        params, mu, nu = scene.make_state(gen, video, self.model, self.spec_state, self.device)
        cloud = video.cloud
        self.points = cloud["means"].cpu().numpy()
        points_rgb = torch.clamp(cloud["colors"], 0.0, 1.0).cpu().numpy()
        self.video = video._replace(cloud=None, exposures=video.exposures.cpu())
        self.host = {"params": scene.to_device(params, "cpu"), "mu": scene.to_device(mu, "cpu"),
                     "nu": scene.to_device(nu, "cpu")}
        del gen, video, cloud, params, mu, nu
        free(self.device)
        return points_rgb

    def _trainer(self, points_rgb, config_seed: int):
        from casualhdrsplat_torch import config as config_mod
        from casualhdrsplat_torch.data.dataset import Dataset
        from casualhdrsplat_torch.train.trainer import Trainer

        cfg = config_mod.from_dict(self.cfg_dict)
        cfg.seed = config_seed
        fx, fy, cx, cy, width, height = self.video.cam
        dataset = Dataset(images=self.video.images, timestamps=self.video.timestamps,
                          viewmats=self.video.viewmats, fx=fx, fy=fy, cx=cx, cy=cy, width=width,
                          height=height, points_xyz=self.points, points_rgb=points_rgb)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        trainer = Trainer(cfg, dataset, device=self.device)
        if config_mod.to_dict(trainer.cfg)["model"] != {**self.model}:
            raise RuntimeError("the trainer changed the configuration it was given (its start-up "
                               "guard left shared binning?): the cell would not measure its "
                               "configuration")
        return trainer

    def _load(self, step: int, moments: bool) -> None:
        """Put the benchmark's state into the trainer, as Trainer.load
        restores a checkpoint: parameters, Adam moments and count, fresh
        statistics, the step counter."""
        from casualhdrsplat_torch.train import densify as densify_mod

        t = self.trainer
        params = scene.to_device(self.host["params"], self.device)
        with t.lock:
            t.params = params
            if moments:
                opt = {"count": step, "mu": {"crf": {}}, "nu": {"crf": {}}}
                for path, _ in ref_train.LEAVES:
                    for m in ("mu", "nu"):
                        node = opt[m]
                        for k in path[:-1]:
                            node = node.setdefault(k, {})
                        host = self.host[m][ref_train.leaf_name(path)]
                        node[path[-1]] = host.to(self.device, copy=True)
                t.opt_state = opt
                t.adc = densify_mod.AdcState.zero(params["gaussians"]["alive"].shape[0],
                                                  self.device)
            t.step = step

    def phase(self, name: str) -> None:
        """Record the seconds since the last phase ended (set-up's parts)."""
        sync(self.device)
        now = time.perf_counter()
        self.phases[name] = round(now - self._clock, 3)
        self._clock = now

    def ref_scene(self):
        v = self.video
        return ref.make_scene(torch.as_tensor(v.viewmats, device=self.device), v.timestamps,
                              v.cam)

    def counters_line(self) -> Dict[str, int]:
        """Launches of the port's kernels so far (graph replays included)."""
        from casualhdrsplat_torch.ops import crf_fused, rasterize_dense, rasterize_packed
        from casualhdrsplat_torch.ops import stream_gather

        kernels = {"B1": rasterize_packed.FWD_KERNEL, "B2": rasterize_packed.BWD_KERNEL,
                   "B3": rasterize_dense.FWD_KERNEL, "B4": rasterize_dense.BWD_KERNEL,
                   "G1": stream_gather.KERNEL, "T1_fwd": crf_fused.FWD_KERNEL,
                   "T1_bwd": crf_fused.BWD_KERNEL}
        return {k: v.launches for k, v in kernels.items()}
