"""Grid-layer visualization: PNG export, colormaps, terrain artifact.

A copy of ``groundgrid_tpu/runtime/viz.py`` (NumPy and the standard library
only), held to it byte for byte by ``tests/test_torch_shared.py``.

ROS-free replacement for the reference's image publishers
(``GroundGridNodelet.cpp:219-291``): per-layer colormapped images (the
reference uses OpenCV's TWILIGHT colormap on min/max-normalized layers,
:240-245) and the special 3-channel float "terrain" artifact (height,
3x3-coverage flag, point count) whose filename encodes ``seq_x_y`` just as the
reference encoded them in the image frame_id (:286-288).

PNG writing is dependency-free (stdlib zlib); no OpenCV/PIL needed.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    chunk = tag + data
    return struct.pack(">I", len(data)) + chunk + struct.pack(">I", zlib.crc32(chunk))


def png_bytes(rgb: np.ndarray) -> bytes:
    """Encode an (H, W, 3) uint8 array as PNG bytes (no external deps)."""
    h, w, c = rgb.shape
    assert c == 3 and rgb.dtype == np.uint8
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    out += _png_chunk(b"IDAT", zlib.compress(raw, 6))
    out += _png_chunk(b"IEND", b"")
    return out


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as PNG (no external deps)."""
    with open(path, "wb") as f:
        f.write(png_bytes(rgb))


def _twilight_colormap() -> np.ndarray:
    """A 256x3 cyclic colormap approximating OpenCV's COLORMAP_TWILIGHT.

    Piecewise-smooth cyclic ramp (white -> blue -> black -> red -> white);
    visual purpose only (the reference uses it for layer debugging images).
    """
    t = np.linspace(0.0, 2.0 * np.pi, 256)
    r = 0.55 + 0.45 * np.cos(t)
    b = 0.55 + 0.45 * np.cos(t - np.pi / 2)
    g = 0.45 + 0.40 * np.cos(t - np.pi / 4)
    lut = np.stack([r, g, b], axis=-1)
    return np.clip(lut * 255.0, 0, 255).astype(np.uint8)


_TWILIGHT = _twilight_colormap()


def layer_to_rgb(layer: np.ndarray) -> np.ndarray:
    """Min/max normalize a float layer and apply the colormap.

    Mirrors grid_map's toImage<uchar,1> + applyColorMap
    (GroundGridNodelet.cpp:240-241). Non-finite cells render black.
    """
    a = np.asarray(layer, np.float64)
    finite = np.isfinite(a)
    if finite.any():
        lo = a[finite].min()
        hi = a[finite].max()
        scale = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
    else:
        scale = np.zeros_like(a)
    idx = np.clip((scale * 255.0), 0, 255).astype(np.uint8)
    rgb = _TWILIGHT[idx]
    rgb[~finite] = 0
    return rgb


def export_layers(layers: dict, out_dir: str, prefix: str = "") -> list[str]:
    """Dump every grid layer as a colormapped PNG (one per layer)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, layer in layers.items():
        p = os.path.join(out_dir, f"{prefix}{name}.png")
        write_png(p, layer_to_rgb(np.asarray(layer)))
        paths.append(p)
    return paths


def render_segmented_cloud(
    x: np.ndarray,
    y: np.ndarray,
    labels: np.ndarray,
    center_xy,
    extent: float = 60.0,
    size: int = 720,
) -> np.ndarray:
    """Top-down image of a segmented cloud (the RViz display substitute).

    The reference visualizes the segmented cloud in RViz colored by the
    intensity channel (rviz/groundgrid.rviz); this renders the same view as
    an (size, size, 3) uint8 image: ground points green, non-ground red,
    outliers/dropped dim gray, ego-centered.
    """
    img = np.zeros((size, size, 3), np.uint8)
    scale = size / (2.0 * extent)
    u = ((center_xy[0] + extent - np.asarray(x)) * scale).astype(np.int64)
    v = ((center_xy[1] + extent - np.asarray(y)) * scale).astype(np.int64)
    ok = (u >= 0) & (u < size) & (v >= 0) & (v < size)
    lab = np.asarray(labels)
    colors = {49: (40, 220, 60), 99: (230, 50, 50), 0: (80, 80, 80)}
    for value, color in colors.items():
        m = ok & (lab == value)
        img[u[m], v[m]] = color
    return img


class SequenceRecorder:
    """Collect per-scan renders into a self-contained interactive HTML player.

    The TPU-native replacement for the reference's live RViz playback
    (``rviz/groundgrid.rviz`` + ``launch/KITTIPlayback.launch:51``): each
    recorded scan becomes one frame (top-down segmented-cloud render,
    optionally with a grid-layer inset), and :meth:`write_html` emits a
    single HTML file with play/pause, frame scrubbing, speed control and
    keyboard stepping -- viewable anywhere, no ROS/RViz/network needed.

    Frames are PNG-encoded on ``add`` (bounded memory) and embedded as
    base64 data URIs. ``max_frames`` caps the file size; adds beyond it are
    dropped with a counter, so a full 4540-scan sequence can be streamed
    through a strided recorder without pre-counting.
    """

    def __init__(self, extent: float = 60.0, size: int = 720,
                 max_frames: int = 400, embed_3d_every: int = 0,
                 max_3d: int = 40):
        self.extent = float(extent)
        self.size = int(size)
        self.max_frames = int(max_frames)
        # 3-D embedding: every Kth recorded frame also stores a packed cloud
        # (~0.5 MB -> ~0.7 MB of base64 in the file); max_3d caps file growth
        self.embed_3d_every = int(embed_3d_every)
        self.max_3d = int(max_3d)
        self.frames: list[bytes] = []
        self.captions: list[str] = []
        self.clouds: dict[int, dict] = {}  # recorded-frame ordinal -> packed
        self.dropped = 0

    def add(self, x, y, labels, center_xy, caption: str = "",
            layer: np.ndarray | None = None, z=None, z0: float = 0.0,
            resolution: float | None = None) -> bool:
        """Render + append one frame; returns False when at capacity.

        ``layer``: optional (N, N) float grid layer rendered as a
        quarter-size colormapped inset (bottom-right), mirroring the
        reference's per-layer image publishers alongside the cloud view.
        With ``z`` and ``embed_3d_every`` set, a packed 3-D cloud (terrain
        underlay from ``layer``) is embedded for the player's 3-D toggle.
        """
        if len(self.frames) >= self.max_frames:
            self.dropped += 1
            return False
        ordinal = len(self.frames)
        if (z is not None and self.embed_3d_every > 0
                and ordinal % self.embed_3d_every == 0
                and len(self.clouds) < self.max_3d):
            self.clouds[ordinal] = pack_cloud_3d(
                x, y, z, labels, center_xy, z0,
                ground=layer, resolution=resolution,
            )
        img = render_segmented_cloud(x, y, labels, center_xy, self.extent, self.size)
        if layer is not None:
            inset = layer_to_rgb(np.asarray(layer))
            k = self.size // 4
            idx = np.minimum(
                (np.arange(k)[:, None] * inset.shape[0]) // k, inset.shape[0] - 1
            )
            small = inset[idx, (np.arange(k)[None, :] * inset.shape[1]) // k]
            img[-k:, -k:] = small
        self.frames.append(png_bytes(img))
        self.captions.append(caption)
        return True

    def write_html(self, path: str, title: str = "groundgrid-torch playback") -> str:
        """Write the self-contained player; returns ``path``."""
        import base64
        import json as _json

        uris = [
            "data:image/png;base64," + base64.b64encode(f).decode("ascii")
            for f in self.frames
        ]
        html = _PLAYER_HTML.replace("__TITLE__", title)
        html = html.replace("__CLOUD3D_JS__", CLOUD3D_JS)
        html = html.replace("__FRAMES__", _json.dumps(uris))
        html = html.replace("__CAPTIONS__", _json.dumps(self.captions))
        html = html.replace(
            "__CLOUDS__", _json.dumps({str(k): v for k, v in self.clouds.items()})
        )
        with open(path, "w") as f:
            f.write(html)
        return path


_PLAYER_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
body{background:#111;color:#ddd;font-family:monospace;text-align:center;margin:0}
#wrap{display:inline-block;margin-top:12px}
img{image-rendering:pixelated;border:1px solid #333;max-width:92vw}
#gl{border:1px solid #333;max-width:92vw;display:none;cursor:grab}
#bar{margin:8px 0}
button{background:#222;color:#ddd;border:1px solid #444;padding:4px 12px;
margin:0 4px;cursor:pointer;font-family:monospace}
button.on{background:#264;border-color:#4a8}
input[type=range]{width:60%;vertical-align:middle}
#cap{color:#8c8;min-height:1.2em}
.legend span{margin:0 10px}
</style></head><body><div id="wrap">
<h3>__TITLE__</h3>
<img id="view" alt="frame">
<canvas id="gl" width="960" height="600"></canvas>
<div id="cap"></div>
<div id="bar">
<button id="play">&#9654;</button>
<button id="prev">&#9664;&#9664;</button>
<button id="next">&#9654;&#9654;</button>
<button id="d3" style="display:none">3-D</button>
<input type="range" id="seek" min="0" value="0">
<span id="pos"></span>
<select id="fps"><option>2</option><option>5</option><option selected>10</option>
<option>20</option><option>30</option></select> fps
</div>
<div class="legend"><span style="color:#28dc3c">&#9632; ground</span>
<span style="color:#e63232">&#9632; non-ground</span>
<span style="color:#888">&#9632; dropped</span></div>
</div><script>
__CLOUD3D_JS__
const F=__FRAMES__,C=__CAPTIONS__,CL=__CLOUDS__;let i=0,t=null,mode3d=false;
const v=document.getElementById('view'),s=document.getElementById('seek'),
p=document.getElementById('pos'),cap=document.getElementById('cap'),
play=document.getElementById('play'),gl=document.getElementById('gl'),
d3btn=document.getElementById('d3');
const view3d=gg3dView(gl);
const clKeys=Object.keys(CL).map(Number).sort((a,b)=>a-b);
if(clKeys.length)d3btn.style.display='';
function show3d(j){
  // nearest embedded cloud at or before frame j (sparse embedding)
  let k=-1;for(const c of clKeys){if(c<=j)k=c;else break;}
  if(k<0)k=clKeys[0];
  const d=CL[String(k)];
  view3d.setCloud(d,'frame '+k+'  '+d.n+' pts (stride '+d.stride+')');
}
function show(j){i=(j+F.length)%F.length;v.src=F[i];s.value=i;
p.textContent=(i+1)+'/'+F.length;cap.textContent=C[i]||'';
if(mode3d)show3d(i);}
d3btn.onclick=()=>{mode3d=!mode3d;
  d3btn.className=mode3d?'on':'';
  v.style.display=mode3d?'none':'';
  gl.style.display=mode3d?'':'none';
  if(mode3d)show3d(i);};
function tick(){show(i+1);}
function toggle(){if(t){clearInterval(t);t=null;play.innerHTML='&#9654;';}
else{t=setInterval(tick,1000/+document.getElementById('fps').value);
play.innerHTML='&#10074;&#10074;';}}
play.onclick=toggle;
document.getElementById('next').onclick=()=>show(i+1);
document.getElementById('prev').onclick=()=>show(i-1);
s.oninput=e=>show(+e.target.value);
document.getElementById('fps').onchange=()=>{if(t){toggle();toggle();}};
document.addEventListener('keydown',e=>{
if(e.key==='ArrowRight')show(i+1);else if(e.key==='ArrowLeft')show(i-1);
else if(e.key===' '){e.preventDefault();toggle();}});
if(F.length)show(0);
</script></body></html>
"""


def pack_cloud_3d(
    x,
    y,
    z,
    labels,
    center_xy,
    z0: float,
    ground: np.ndarray | None = None,
    resolution: float | None = None,
    max_points: int = 60000,
    terrain_side: int = 96,
) -> dict:
    """Pack one segmented cloud (+ optional terrain underlay) for the 3-D view.

    The 3-D perspective viewer (the RViz-display analog,
    ``rviz/groundgrid.rviz``: segmented cloud colored by class over the
    terrain estimate) consumes ego-relative int16-centimeter coordinates —
    7 bytes/point — as base64 fields the browser decodes into typed arrays.

    ``center_xy``/``z0`` define the ego frame (grid center, terrain height
    under the vehicle). ``ground`` (N, N) is subsampled to ``terrain_side``
    per side on the grid's cell-center lattice
    (``pos = center + half - (idx + 0.5) * res``, core/grid.py).
    Points are cell-sorted in sorted-scans mode, so stride subsampling to
    ``max_points`` stays spatially uniform.
    """
    import base64

    def b64(a: np.ndarray) -> str:
        return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode("ascii")

    x = np.asarray(x, np.float32)
    n = len(x)
    stride = max(1, -(-n // max_points))
    sel = slice(0, n, stride)
    cx, cy = float(center_xy[0]), float(center_xy[1])

    def cm16(v) -> np.ndarray:
        return np.clip(np.round(v * 100.0), -32000, 32000).astype(np.int16)

    out = dict(
        n=len(x[sel]),
        stride=stride,
        x=b64(cm16(x[sel] - cx)),
        y=b64(cm16(np.asarray(y, np.float32)[sel] - cy)),
        z=b64(cm16(np.asarray(z, np.float32)[sel] - z0)),
        lab=b64(np.asarray(labels).astype(np.uint8)[sel]),
    )
    if ground is not None and resolution is not None:
        g = np.asarray(ground, np.float32)
        gn = g.shape[0]
        gs = max(1, -(-gn // terrain_side))
        idx = np.arange(0, gn, gs)
        half = gn * resolution / 2.0
        # cell-center offset from ego of lattice index 0, and the (negative)
        # step along increasing index (index 0 is the max-position corner)
        origin_cm = (half - (idx[0] + 0.5) * resolution) * 100.0
        out["terrain"] = dict(
            n=len(idx),
            step_cm=-gs * resolution * 100.0,
            origin_cm=origin_cm,
            h=b64(cm16(g[np.ix_(idx, idx)] - z0)),
        )
    return out


# Shared browser-side 3-D renderer (used by the live page and the offline
# player): decodes pack_cloud_3d fields and draws z-buffered perspective
# point splats (class colors) over the terrain lattice on a 2-D canvas.
# gg3dView(canvas) wires orbit (drag) + zoom (wheel) and exposes setCloud().
CLOUD3D_JS = """
function gg3dB64i16(s){const b=atob(s),u=new Uint8Array(b.length);
  for(let i=0;i<b.length;i++)u[i]=b.charCodeAt(i);
  return new Int16Array(u.buffer);}
function gg3dB64u8(s){const b=atob(s),u=new Uint8Array(b.length);
  for(let i=0;i<b.length;i++)u[i]=b.charCodeAt(i);return u;}
function gg3dView(canvas){
  const ctx=canvas.getContext('2d');
  const st={yaw:0.7,pitch:0.55,dist:4200,cloud:null,label:''};
  function render(){
    const cloud=st.cloud;
    if(!cloud)return;
    const W=canvas.width,H=canvas.height,f=H*1.15;
    const im=ctx.createImageData(W,H),px=im.data;
    const zb=new Float32Array(W*H).fill(1e12);
    const ca=Math.cos(st.yaw),sa=Math.sin(st.yaw);
    const cb=Math.cos(st.pitch),sb=Math.sin(st.pitch);
    function splat(x,y,z,r,g,b,s){
      const t=ca*x+sa*y, w=cb*t-sb*z+st.dist;
      if(w<60)return;
      const u=(W>>1)+f*(-sa*x+ca*y)/w, v=(H>>1)-f*(sb*t+cb*z)/w;
      const ui=u|0, vi=v|0;
      for(let dv=0;dv<s;dv++)for(let du=0;du<s;du++){
        const uu=ui+du, vv=vi+dv;
        if(uu<0||uu>=W||vv<0||vv>=H)continue;
        const k=vv*W+uu;
        if(w<zb[k]){zb[k]=w;const o=k*4;
          px[o]=r;px[o+1]=g;px[o+2]=b;px[o+3]=255;}
      }
    }
    const t3=cloud.terrain;
    if(t3){
      const h=gg3dB64i16(t3.h), n=t3.n;
      for(let i=0;i<n;i++)for(let j=0;j<n;j++){
        const hv=h[i*n+j];
        const x=t3.origin_cm+i*t3.step_cm, y=t3.origin_cm+j*t3.step_cm;
        const c=Math.max(0,Math.min(200,110+hv*0.35));
        splat(x,y,hv,c*0.35,c*0.5,c*0.62,3);
      }
    }
    const X=gg3dB64i16(cloud.x),Y=gg3dB64i16(cloud.y);
    const Z=gg3dB64i16(cloud.z),L=gg3dB64u8(cloud.lab);
    for(let i=0;i<cloud.n;i++){
      const l=L[i];
      if(l===49)splat(X[i],Y[i],Z[i],40,220,60,2);
      else if(l===99)splat(X[i],Y[i],Z[i],230,50,50,2);
      else splat(X[i],Y[i],Z[i],90,90,90,2);
    }
    for(let k=0;k<8;k++)splat(0,0,k*25,255,255,255,3); // ego pillar
    ctx.putImageData(im,0,0);
    ctx.fillStyle='#9c9';ctx.font='12px monospace';
    ctx.fillText(st.label,8,14);
  }
  let drag=null;
  canvas.onmousedown=e=>{drag=[e.clientX,e.clientY];canvas.style.cursor='grabbing';};
  window.addEventListener('mouseup',()=>{drag=null;canvas.style.cursor='grab';});
  window.addEventListener('mousemove',e=>{if(!drag)return;
    st.yaw+=(e.clientX-drag[0])*0.008;
    st.pitch=Math.max(0.05,Math.min(1.5,st.pitch+(e.clientY-drag[1])*0.008));
    drag=[e.clientX,e.clientY];render();});
  canvas.onwheel=e=>{e.preventDefault();
    st.dist=Math.max(500,Math.min(30000,st.dist*(e.deltaY>0?1.12:0.89)));
    render();};
  return {setCloud(d,label){st.cloud=d;st.label=label||'';render();},render};
}
"""


def terrain_artifact(ground: np.ndarray, points_raw: np.ndarray) -> np.ndarray:
    """The reference's 32FC3 terrain image (GroundGridNodelet.cpp:247-270).

    Channels: [terrain height, 3x3-coverage flag (block sum of pointsRaw
    >= 27), per-cell raw point count].
    """
    g = np.asarray(ground, np.float32)
    pr = np.asarray(points_raw, np.float32)
    n = pr.shape[0]
    padded = np.zeros((n + 2, n + 2), np.float32)
    padded[1:-1, 1:-1] = pr
    block = sum(
        padded[1 + di : n + 1 + di, 1 + dj : n + 1 + dj]
        for di in (-1, 0, 1)
        for dj in (-1, 0, 1)
    )
    coverage = (block >= 27.0).astype(np.float32)
    return np.stack([g, coverage, pr], axis=-1)


def save_terrain_artifact(
    path_dir: str, ground, points_raw, seq: int, utm_x: float, utm_y: float
) -> str:
    """Persist the terrain artifact with the seq+position encoding (:287)."""
    os.makedirs(path_dir, exist_ok=True)
    arr = terrain_artifact(ground, points_raw)
    path = os.path.join(path_dir, f"{seq}_{utm_x:.6f}_{utm_y:.6f}.npy")
    np.save(path, arr)
    return path
