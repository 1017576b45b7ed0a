"""Interactive training viewer.  Counterpart of
casualhdrsplat_tpu/viewer/server.py.

A background HTTP server that renders the current model from an orbiting
camera on request.  Open http://host:port/ for a minimal page that polls
/render.jpg; query parameters drive pose, exposure and mode:

    /render.jpg?angle=0.3&log_exposure=0.5&mode=ldr|hdr

Rendering runs through render_pose, the path eval takes, so the viewer
doubles as a liveness probe of the deployed model.  JPEG encoding needs
PIL.
"""

from __future__ import annotations

import io
import itertools
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = b"""<!doctype html><title>casualhdrsplat_torch viewer</title>
<body style="background:#111;color:#eee;font-family:monospace">
<h3>casualhdrsplat_torch viewer</h3>
<div>angle <input id=a type=range min=-3.14 max=3.14 step=0.02 value=0>
exposure <input id=e type=range min=-2 max=2 step=0.1 value=0></div>
<img id=v width=512 style="image-rendering:pixelated">
<script>
const img=document.getElementById('v');
function tick(){
  const a=document.getElementById('a').value, e=document.getElementById('e').value;
  img.src=`/render.jpg?angle=${a}&log_exposure=${e}&t=${Date.now()}`;
}
img.onload=()=>setTimeout(tick,100); img.onerror=()=>setTimeout(tick,1000); tick();
</script>"""


class ViewerServer:
    """Serve live renders of a training/trained model.

    render_fn(angle: float, log_exposure: float, mode: str) -> [H,W,3]
    float image in [0,1] as a host array (the caller binds it to the
    current params).  Each request renders on its own thread.
    """

    def __init__(self, render_fn, host: str = "0.0.0.0", port: int = 7007):
        self.render_fn = render_fn
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                url = urlparse(self.path)
                if url.path in ("/", "/index.html"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)
                    return
                if url.path == "/render.jpg":
                    q = parse_qs(url.query)
                    angle = float(q.get("angle", ["0"])[0])
                    log_exp = float(q.get("log_exposure", ["0"])[0])
                    mode = q.get("mode", ["ldr"])[0]
                    try:
                        img = np.asarray(outer.render_fn(angle, log_exp, mode))
                        payload = _encode_jpg(img)
                    except Exception as e:  # surface errors to the client
                        self.send_response(500)
                        self.end_headers()
                        self.wfile.write(str(e).encode())
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                self.send_response(404)
                self.end_headers()

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "ViewerServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()


def _encode_jpg(img: np.ndarray) -> bytes:
    from PIL import Image

    arr = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def make_orbit_render_fn(trainer, radius: float = 4.0):
    """Bind a Trainer to the viewer: orbit camera and exposure editing.

    Adam writes the trainer's parameters in place, and a request renders
    on the server's thread: each render holds `trainer.lock`, which the
    trainer holds across a step, so it sees one step's parameters.  On
    the card a render replays a CUDA graph (`trainer.renders`).  A request
    is the span `chs.request` with its children `.camera`, `.lock`,
    `.launch` and `.copy_out` (utils/profiling.py), its ordinal their
    unit."""
    import torch

    from casualhdrsplat_torch.data import synthetic
    from casualhdrsplat_torch.models import image_formation as imf
    from casualhdrsplat_torch.utils import profiling

    ordinals = itertools.count()

    def render(angle: float, log_exposure: float, mode: str):
        unit = next(ordinals)
        with profiling.span("request", unit):
            with profiling.span("request.camera", unit):
                cam = synthetic.orbit_camera(
                    angle, radius=radius, width=trainer.dataset.width,
                    img_height=trainer.dataset.height, device=trainer.device,
                )
            with profiling.span("request.lock", unit):
                trainer.lock.acquire()
            try:
                with torch.no_grad():
                    with profiling.span("request.launch", unit):
                        img, _, _ = trainer.renders.render_pose(
                            trainer.params, trainer.scene, cam.viewmat, trainer.cfg.model,
                            exposure=torch.exp(torch.tensor(log_exposure,
                                                            device=trainer.device)),
                            hdr_output=(mode == "hdr"),
                        )
                    with profiling.span("request.copy_out", unit):
                        return img.cpu().numpy()
            finally:
                trainer.lock.release()

    return render
