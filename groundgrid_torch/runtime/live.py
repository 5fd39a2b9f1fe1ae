"""Live sequence viewer: watch a *running* sequence from a browser.

A copy of ``groundgrid_tpu/runtime/live.py`` (the standard library and
NumPy only), held to it by ``tests/test_torch_shared.py``.

Closes the last RViz gap (VERDICT r2 item 8): the reference's
``rviz/groundgrid.rviz`` shows the segmented cloud live while a sequence
plays; the HTML player (``runtime/viz.py``) is record-then-scrub. This module
serves the same player over HTTP with an append/follow protocol, so frames
appear in the browser as scans are processed:

  * ``GET /``                 -> self-contained live player page
  * ``GET /frames?since=K``   -> JSON {"next": N, "start": S, "frames": [...],
                                 "captions": [...]} with frames K..N-1
                                 (empty list when nothing new; S = oldest
                                 retained frame for late-joining viewers)
  * ``GET /status``           -> JSON {"total": N, "done": bool}

Pure stdlib (http.server in a daemon thread); frame rendering reuses
``runtime/viz.py``. Memory is bounded: a ring of the most recent ``keep``
PNG frames (late viewers start at the oldest retained frame).

Wired to ``groundgrid-torch playback --serve PORT``.
"""

from __future__ import annotations

import base64
import json
import threading
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from groundgrid_torch.runtime.viz import (
    layer_to_rgb, pack_cloud_3d, png_bytes, render_segmented_cloud,
)


class LiveServer:
    """Bounded live frame buffer + HTTP server (one per playback run)."""

    def __init__(self, port: int = 8791, extent: float = 60.0,
                 size: int = 720, keep: int = 600, host: str = "127.0.0.1",
                 keep3d: int = 60):
        self.extent = float(extent)
        self.size = int(size)
        self.keep = int(keep)
        self.keep3d = int(keep3d)  # packed clouds are ~0.5 MB each
        self._lock = threading.Lock()
        self._frames: deque[str] = deque()  # data URIs, most recent `keep`
        self._captions: deque[str] = deque()
        self._clouds: dict[int, dict] = {}  # frame index -> packed 3-D cloud
        self._cloud_order: deque[int] = deque()
        self._total = 0  # frames ever added; ring start = _total - len
        self._done = False
        self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    # ------------------------------------------------------------- producer
    def add(self, x, y, labels, center_xy, caption: str = "",
            layer: np.ndarray | None = None, z=None, z0: float = 0.0,
            resolution: float | None = None) -> bool:
        """Render + publish one frame (same signature as SequenceRecorder.add).

        When ``z`` is given, also packs the cloud (with ``layer`` as the
        terrain underlay) for the page's 3-D perspective toggle.
        """
        cloud3d = None
        if z is not None:
            cloud3d = pack_cloud_3d(
                x, y, z, labels, center_xy, z0,
                ground=layer, resolution=resolution,
            )
        img = render_segmented_cloud(
            x, y, labels, center_xy, self.extent, self.size
        )
        if layer is not None:
            inset = layer_to_rgb(np.asarray(layer))
            k = self.size // 4
            idx = np.minimum(
                (np.arange(k)[:, None] * inset.shape[0]) // k,
                inset.shape[0] - 1,
            )
            small = inset[idx, (np.arange(k)[None, :] * inset.shape[1]) // k]
            img[-k:, -k:] = small
        uri = "data:image/png;base64," + base64.b64encode(
            png_bytes(img)
        ).decode("ascii")
        with self._lock:
            if cloud3d is not None:
                self._clouds[self._total] = cloud3d
                self._cloud_order.append(self._total)
                while len(self._cloud_order) > self.keep3d:
                    self._clouds.pop(self._cloud_order.popleft(), None)
            self._frames.append(uri)
            self._captions.append(caption)
            self._total += 1
            while len(self._frames) > self.keep:
                self._frames.popleft()
                self._captions.popleft()
        return True

    def finish(self) -> None:
        """Mark the sequence complete (the page shows 'done')."""
        with self._lock:
            self._done = True

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "LiveServer":
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/"

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    # ------------------------------------------------------------- protocol
    def _snapshot(self, since: int):
        with self._lock:
            start = self._total - len(self._frames)
            lo = max(since, start)
            k = lo - start
            frames = list(self._frames)[k:]
            captions = list(self._captions)[k:]
            return dict(
                next=self._total, start=start, frames=frames,
                captions=captions, done=self._done,
            )

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, body: bytes, ctype: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    from groundgrid_torch.runtime.viz import CLOUD3D_JS

                    page = _LIVE_HTML.replace("__CLOUD3D_JS__", CLOUD3D_JS)
                    self._send(page.encode(), "text/html; charset=utf-8")
                elif u.path == "/frames":
                    q = parse_qs(u.query)
                    since = int(q.get("since", ["0"])[0])
                    body = json.dumps(server._snapshot(since)).encode()
                    self._send(body, "application/json")
                elif u.path == "/cloud":
                    q = parse_qs(u.query)
                    i = int(q.get("i", ["-1"])[0])
                    with server._lock:
                        # nearest retained cloud at or before frame i
                        cand = [k for k in server._cloud_order if k <= i]
                        body = (json.dumps(dict(server._clouds[max(cand)],
                                                frame=max(cand)))
                                if cand else "null")
                    self._send(body.encode(), "application/json")
                elif u.path == "/status":
                    with server._lock:
                        body = json.dumps(
                            dict(total=server._total, done=server._done)
                        ).encode()
                    self._send(body, "application/json")
                else:
                    self.send_error(404)

        return Handler


_LIVE_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>groundgrid-torch live</title>
<style>
body{background:#111;color:#ddd;font-family:system-ui,sans-serif;margin:0;
     display:flex;flex-direction:column;align-items:center}
#img{max-width:96vw;max-height:82vh;image-rendering:pixelated;margin-top:8px}
#gl{max-width:96vw;margin-top:8px;display:none;cursor:grab}
#bar{display:flex;gap:10px;align-items:center;padding:8px}
button{background:#333;color:#ddd;border:1px solid #555;border-radius:4px;
       padding:4px 10px;cursor:pointer}
button.on{background:#264;border-color:#4a8}
#cap{color:#9c9;min-height:1.2em}
input[type=range]{width:40vw}
.legend{color:#888;font-size:0.85em}
</style></head><body>
<div id="bar">
  <button id="follow">following &#9679;</button>
  <button id="d3">3-D</button>
  <input type="range" id="seek" min="0" max="0" value="0">
  <span id="pos">0/0</span>
  <span id="state" style="color:#888">live</span>
</div>
<img id="img" alt="waiting for frames...">
<canvas id="gl" width="960" height="600"></canvas>
<div id="cap"></div>
<div class="legend"><span style="color:#2c4">&#9632; ground</span>
<span style="color:#e33">&#9632; non-ground</span>
<span style="color:#888">&#9632; dropped</span>
<span id="hint3d" style="display:none">&middot; drag orbits, wheel zooms</span></div>
<script>
__CLOUD3D_JS__
let frames=[], captions=[], start=0, next=0, cur=-1, follow=true, done=false;
let mode3d=false, cloudFrame=-1, fetching=false;
const img=document.getElementById('img'), cap=document.getElementById('cap');
const seek=document.getElementById('seek'), pos=document.getElementById('pos');
const fbtn=document.getElementById('follow'), state=document.getElementById('state');
const gl=document.getElementById('gl'), d3btn=document.getElementById('d3');
const view3d=gg3dView(gl);
async function fetchCloud(i){
  if(fetching)return; fetching=true;
  try{
    const r=await fetch('/cloud?i='+i);
    const d=await r.json();
    if(d&&d.frame!==cloudFrame){cloudFrame=d.frame;
      view3d.setCloud(d,'frame '+d.frame+'  '+d.n+' pts (stride '+d.stride+')');}
  }catch(e){}
  fetching=false;
}
function show(i){
  if(i<start||i>=next) return;
  cur=i; img.src=frames[i-start]; cap.textContent=captions[i-start];
  seek.min=start; seek.max=Math.max(next-1,start); seek.value=i;
  pos.textContent=(i+1)+'/'+next;
  if(mode3d)fetchCloud(i);
}
d3btn.onclick=()=>{mode3d=!mode3d;
  d3btn.className=mode3d?'on':'';
  img.style.display=mode3d?'none':'';
  gl.style.display=mode3d?'':'none';
  document.getElementById('hint3d').style.display=mode3d?'':'none';
  if(mode3d&&cur>=0)fetchCloud(cur);};
fbtn.onclick=()=>{follow=!follow;
  fbtn.innerHTML=follow?'following &#9679;':'paused &#9616;&#9616;';
  if(follow&&next>0) show(next-1);};
seek.oninput=()=>{follow=false;
  fbtn.innerHTML='paused &#9616;&#9616;'; show(+seek.value);};
document.addEventListener('keydown',e=>{
  if(e.key==='ArrowLeft') {follow=false; show(Math.max(cur-1,start));}
  if(e.key==='ArrowRight'){follow=false; show(Math.min(cur+1,next-1));}
  if(e.key===' ') {e.preventDefault(); fbtn.onclick();}});
async function poll(){
  try{
    const r=await fetch('/frames?since='+next);
    const d=await r.json();
    if(d.start>next){ frames=[]; captions=[]; start=d.start; next=d.start; }
    if(frames.length===0) start=d.start>next?d.start:Math.max(start,d.start);
    frames.push(...d.frames); captions.push(...d.captions);
    next=d.next; done=d.done;
    if(done) state.textContent='done ('+next+' frames)';
    if(follow&&next>0) show(next-1); else if(cur<0&&next>0) show(start);
  }catch(e){ state.textContent='disconnected'; }
  setTimeout(poll, done?2000:500);
}
poll();
</script></body></html>
"""
