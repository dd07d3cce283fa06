"""Zero-dependency browser viewer (``ngp_tpu/viewer_web.py``).

A copy of the JAX package's viewer: one HTML page with mouse
orbit/zoom/pan controls, which polls ``/frame`` for JPEG renders and
``/stats`` for training status, and sends its widgets to ``/ctl``. The
headless replacement for the reference's DearPyGui window
(nerf/gui.py): live training toggle, FoV, dynamic resolution, SPP
accumulation over plain HTTP. The HTTP threads only touch the camera and
queue requests on the session; the main thread owns the card
(``serve``).

Usage:
    from ngp_tpu_torch.viewer import InteractiveSession
    from ngp_tpu_torch.viewer_web import serve
    serve(InteractiveSession(trainer, train_ds), W=800, H=800, port=7860)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>ngp_tpu viewer</title><style>
body{margin:0;background:#111;color:#ddd;font-family:monospace}
#hud{position:fixed;top:8px;left:8px;background:#0008;padding:6px}
#panel{position:fixed;top:8px;right:8px;background:#0008;padding:6px;font-size:12px}
#panel input[type=range]{width:110px;vertical-align:middle}
img{display:block;margin:auto;cursor:grab}
</style></head><body>
<div id="hud">loading…</div>
<div id="panel">
 <b>crop (aabb_infer)</b><br>
 <span id="sl"></span>
 <b>render</b><br>
 fov <input type="range" id="fov" min="20" max="120" value="60"
  oninput="fetch('/ctl?op=fov&dx='+this.value)"><br>
 max samples/ray <input type="range" id="ms" min="2" max="64" value="32"
  onchange="fetch('/ctl?op=max_samples&dx='+this.value)"><br>
 mean samples/ray <input type="range" id="ems" min="0" max="16" value="4"
  onchange="fetch('/ctl?op=mean_samples&dx='+this.value)"><br>
 <button onclick="fetch('/ctl?op=train')">start/stop training</button>
 <button onclick="fetch('/ctl?op=save_ckpt')">save ckpt</button><br>
 <button onclick="fetch('/ctl?op=mode')">rgb/depth</button>
 <button onclick="fetch('/ctl?op=save_mesh')">save mesh</button>
 <button onclick="fetch('/ctl?op=reset')">reset grid</button>
</div>
<img id="view" width="__W__" height="__H__">
<script>
const axes=['xmin','ymin','zmin','xmax','ymax','zmax'];
const sl=document.getElementById('sl');
axes.forEach((a,i)=>{
 const lo=i<3, v=lo?-100:100;
 sl.innerHTML+=`${a} <input type=range min=-100 max=100 value=${v}
  oninput="fetch('/ctl?op=aabb&axis=${i}&dx='+this.value)"><br>`});
</script>
<script>
let drag=false,btn=0,lx=0,ly=0;
const img=document.getElementById('view');
img.onmousedown=e=>{drag=true;btn=e.button;lx=e.clientX;ly=e.clientY;e.preventDefault()};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
 fetch(`/ctl?op=${btn===0?'orbit':'pan'}&dx=${e.clientX-lx}&dy=${e.clientY-ly}`);
 lx=e.clientX;ly=e.clientY};
img.oncontextmenu=e=>e.preventDefault();
img.onwheel=e=>{fetch(`/ctl?op=scale&dx=${e.deltaY>0?-1:1}`);e.preventDefault()};
document.addEventListener('keydown',e=>{  // time scrub for dynamic scenes
 if(e.key==='['||e.key===']')fetch(`/ctl?op=time&dx=${e.key===']'?0.05:-0.05}`)});
async function loop(){
 while(true){
  const r=await fetch('/frame');const b=await r.blob();
  img.src=URL.createObjectURL(b);
  const s=await (await fetch('/stats')).json();
  document.getElementById('hud').textContent=
   `step ${s.step}  loss ${s.loss?.toFixed?.(5)??'-'}  ${s.train_ms?.toFixed?.(0)??0}ms/train  spp ${s.spp}  ds ${s.downscale.toFixed(2)}`;
 }
}
loop();
</script></body></html>"""


def make_server(session, camera, state, W: int, H: int, port: int):
    """HTTP server serving the viewer page / frames / stats and routing
    /ctl widget ops to the camera + session (separated from the main
    render loop for testability)."""
    import cv2

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                body = _PAGE.replace("__W__", str(W)).replace("__H__", str(H)).encode()
                self._respond(200, "text/html", body)
            elif self.path.startswith("/frame"):
                with state["lock"]:
                    frame = state["frame"]
                if frame is None:
                    frame = np.zeros((H, W, 3), np.uint8)
                ok, buf = cv2.imencode(".jpg", frame[..., ::-1])
                self._respond(200, "image/jpeg", buf.tobytes())
            elif self.path.startswith("/stats"):
                with state["lock"]:
                    body = json.dumps(state["stats"]).encode()
                self._respond(200, "application/json", body)
            elif self.path.startswith("/ctl"):
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                op = q.get("op", [""])[0]
                dx = float(q.get("dx", [0])[0])
                dy = float(q.get("dy", [0])[0])
                if op == "orbit":
                    camera.orbit(dx, dy)
                elif op == "pan":
                    camera.pan(dx, dy)
                elif op == "scale":
                    camera.scale(dx)
                elif op == "time":
                    # dynamic-scene time scrub ('['/']' keys; D-NeRF
                    # GUI time slider parity, dnerf/gui.py:287-293)
                    state["time"] = float(np.clip(state.get("time", 0.0) + dx, 0.0, 1.0))
                elif op == "fov":
                    camera.fovy = float(np.clip(dx, 10.0, 150.0))
                elif op == "aabb":
                    # live 6-dof crop (nerf/gui.py:316-338 aabb_infer
                    # sliders); the next frame reads it
                    axis = int(q.get("axis", [0])[0])
                    session.set_aabb_axis(axis, dx / 100.0)
                elif op == "max_samples":
                    session.request("max_samples", int(dx))
                elif op == "mode":
                    session.mode = "depth" if session.mode == "rgb" else "rgb"
                elif op in ("train", "save_ckpt", "save_mesh", "reset"):
                    session.request(op)
                self._respond(200, "text/plain", b"ok")
            else:
                self._respond(404, "text/plain", b"not found")

        def _respond(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer(("0.0.0.0", port), Handler)


def serve_step(session, camera, state, train: bool = True):
    """One pass of ``serve``'s loop on the calling (device-owning) thread:
    the queued widget requests, a train call while training is on, then
    a view, published to ``state`` for the HTTP threads."""
    session.service_requests()
    stats = {}
    if train and session.training:
        m = session.train_steps()
        stats.update(step=session.trainer.global_step, loss=m["loss"], train_ms=m["ms"])
    else:
        stats.update(step=session.trainer.global_step)
    session.time = state.get("time", 0.0)
    img = session.render_view(camera)
    frame = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    stats.update(spp=session.spp, downscale=session.downscale)
    with state["lock"]:
        state["frame"] = frame
        state["stats"] = stats


def serve(session, W: int = 800, H: int = 800, port: int = 7860, train: bool = True,
          radius: float = 2.0, fovy: float = 60.0):
    """Blocking server loop: interleaves training and rendering on the
    main thread (one thread drives the card), serves frames to browsers;
    ends on KeyboardInterrupt."""
    from ngp_tpu_torch.viewer import OrbitCamera

    camera = OrbitCamera(W, H, r=radius, fovy=fovy)
    state = {"frame": None, "stats": {}, "lock": threading.Lock()}
    server = make_server(session, camera, state, W, H, port)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"[viewer] http://localhost:{port}", flush=True)

    try:
        while True:
            serve_step(session, camera, state, train)
    except KeyboardInterrupt:
        server.shutdown()
