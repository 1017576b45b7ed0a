"""The "serve" kind: a closed loop of viewer requests with one client
(`viewer.server.make_orbit_render_fn`)."""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from benchmark import scene
from benchmark.counts import work as work_mod
from benchmark.loops import BaseLoop, free, sync
from benchmark.reference import geometry as geo
from benchmark.reference import render as ref


class Loop(BaseLoop):
    """A closed loop of viewer requests with one client: each request
    renders the trainer's store from an orbit angle at a log exposure in
    LDR or HDR through the viewer's render function (which holds the
    trainer's lock and returns the image on the host), and the next is sent
    when it returns."""

    def setup(self) -> None:
        from casualhdrsplat_torch.viewer import server

        tr = self.traffic
        self.phase("start")
        points_rgb = self._inputs(render_video=tr["render_video"])
        self.phase("inputs")
        self.trainer = self._trainer(points_rgb, self.seed)
        self.phase("trainer")
        self._load(tr["resume_step"], moments=False)
        self.render = server.make_orbit_render_fn(self.trainer, radius=tr["orbit_radius"])
        lo, hi = np.log(self.spec_scene["exposure_range"])
        self.log_exposure = (lo - tr["log_exposure_widen"], hi + tr["log_exposure_widen"])
        self.rng = np.random.default_rng(self.seed)
        self._modes: List[str] = []
        for _ in range(tr["warmup_per_mode"]):
            for mode in sorted(set(tr["modes"])):
                self.render(*self._request()[:2], mode)
        self.phase("warm_up")

    def _request(self):
        tr = self.traffic
        if not self._modes:
            self._modes = list(self.rng.permutation(tr["modes"]))
        return (float(self.rng.uniform(*tr["angle_range"])),
                float(self.rng.uniform(*self.log_exposure)), str(self._modes.pop()))

    def _serve(self, count: Optional[int], seconds: Optional[float], sample: int,
               mark: bool = False) -> np.ndarray:
        """Requests back to back until `count` are done or `seconds` have
        passed; keeps a reservoir sample (drawn from the seed) of `sample`
        answers.  Returns each request's latency in seconds."""
        keep = np.random.default_rng([self.seed, 1])
        latencies, kept, failed = [], [], 0
        t0 = time.perf_counter()
        i = 0
        while (count is None or i < count) and (
                seconds is None or time.perf_counter() - t0 < seconds):
            req = self._request()
            start = time.perf_counter()
            try:
                if mark:
                    with torch.profiler.record_function("bench.request"):
                        img = self.render(*req)
                else:
                    img = self.render(*req)
            except RuntimeError:
                failed += 1
                img = None
            latencies.append(time.perf_counter() - start)
            if img is not None:
                if len(kept) < sample:
                    kept.append((i, req, img))
                else:
                    j = int(keep.integers(0, i + 1))
                    if j < sample:
                        kept[j] = (i, req, img)
            i += 1
        self.attempted, self.failed, self.kept = i, failed, kept
        return np.asarray(latencies)

    def window(self, seconds: float) -> dict:
        sync(self.device)
        lat = self._serve(None, seconds, self.traffic["sample"])
        ms = lat * 1e3
        return {"render_p50_ms": float(np.percentile(ms, 50)),
                "render_p95_ms": float(np.percentile(ms, 95)), "_requests": len(lat),
                "_ms_p10_p90_max": [float(np.percentile(ms, 10)), float(np.percentile(ms, 90)),
                                    float(ms.max())]}

    def traced_slice(self, profile) -> dict:
        n = self.traffic["trace_requests"]
        state = scene.to_device(scene.clone_tree(self.trainer.params), "cpu")
        requests = []
        orig = self._request

        def record():
            req = orig()
            requests.append(req)
            return req

        self._request = record
        with profile() as p:
            self._serve(n, None, self.traffic["sample"], mark=True)
        self._request = orig
        return {"trace": p, "units": n, "kind": "serve",
                "work": lambda: work_mod.serve_work(state, self.ref_scene(), requests,
                                                     self.model, self.traffic)}

    def release(self) -> None:
        self.trainer = self.render = None
        free(self.device)

    def reference(self, tf32: bool = False) -> list:
        """The reference's answer to every kept request (device images)."""
        from benchmark import compare

        params = scene.to_device(self.host["params"], self.device)
        sc = self.ref_scene()
        with compare.matmul_precision(tf32), torch.no_grad():
            out = [reference_request(params, sc, self.model, angle, log_e, mode, self.traffic,
                                     self.device) for _, (angle, log_e, mode), _ in self.kept]
        del params
        free(self.device)
        return out

    def _gaps(self, images, reference) -> dict:
        from benchmark import compare

        gaps = [float(torch.linalg.norm(torch.as_tensor(got, device=self.device) - want)
                      / torch.linalg.norm(want)) for got, want in zip(images, reference)]
        return compare.serve_gaps(gaps, [req[2] for _, req, _ in self.kept])

    def readings(self, reference: Optional[list] = None) -> dict:
        """The largest relative L2 gap of a served image to the reference's."""
        reference = reference or self.reference()
        return self._gaps([img for _, _, img in self.kept], reference)

    def control_readings(self, reference: list) -> dict:
        """The gaps of the reference in TF32, put in the program's place."""
        return self._gaps(self.reference(tf32=True), reference)


def reference_request(params, sc, model, angle, log_e, mode, traffic: dict, device):
    """The reference's answer to one viewer request."""
    viewmat = geo.orbit_viewmat(angle, traffic["orbit_radius"], traffic["orbit_height"], device)
    exposure = torch.exp(torch.tensor(log_e, dtype=torch.float32, device=device))
    return ref.render_pose(params, sc, viewmat, model, exposure, mode == "hdr",
                           model["sh_degree"])
