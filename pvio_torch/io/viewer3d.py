"""Interactive 3D map viewer: one self-contained HTML file.

The port's copy of `pvio_tpu/io/viewer3d.py`: `scene_snapshot` and
`render_view3d`, host numpy + json, the same page byte for byte (the
default title names this package). It is the peer of the reference's
NanoVis GUI (pvio-pc/src/main.cpp:264-470: landmark cloud, keyframe
frusta, plane patches, trajectory, live update while the run progresses).

A card's host has no display stack, so instead of an X11/GL window this
writes ONE self-contained HTML file (no external assets, no CDN) with the
scene embedded as JSON and a hand-rolled canvas renderer: perspective
projection, painter-sorted points, orbit / zoom / pan mouse controls.
During a live run the file is rewritten every few frames; the page
re-polls itself and keeps the user's camera across reloads
(localStorage). The scene comes from the forensics slots that the port's
sliding-window tracker fills each keyframe solve
(`core/swt.py::_emit_solver_forensics`).
"""

import json
import os

import numpy as np


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def scene_snapshot(bus=None, trajectory=None):
    """Collect the current 3D scene from the forensics slots that
    SlidingWindowTracker emits each keyframe solve
    (core/swt.py:_emit_solver_forensics): landmark cloud, keyframe
    poses, plane states; plus the full output trajectory."""
    if bus is None:
        from pvio_torch.utils.forensics import bus as default_bus

        bus = default_bus
    snap = {"trajectory": [], "frusta": [], "landmarks": [], "planes": []}
    if trajectory:
        snap["trajectory"] = [[float(p[0]), float(p[1]), float(p[2])]
                              for (_, _, p) in trajectory]
    lms = bus.get("sliding_window_landmark_points")
    if lms is not None and len(lms):
        pts = np.asarray(lms, float)
        ok = np.isfinite(pts).all(axis=1) & (np.abs(pts) < 1e3).all(axis=1)
        snap["landmarks"] = [[round(float(v), 4) for v in p]
                             for p in pts[ok]]
    kfs = bus.get("sliding_window_keyframe_poses") or []
    for (_, q, p) in kfs:
        R = _quat_to_mat(np.asarray(q, float))
        snap["frusta"].append({
            "p": [float(v) for v in p],
            "R": [[round(float(v), 5) for v in row] for row in R],
        })
    planes = bus.get("sliding_window_plane_states") or []
    centroid = (np.mean(np.asarray(snap["landmarks"]), axis=0)
                if snap["landmarks"] else np.zeros(3))
    for (n, d) in planes:
        n = np.asarray(n, float)
        n = n / max(np.linalg.norm(n), 1e-12)
        # anchor the display patch at the projection of the landmark
        # centroid onto the plane (plane extents live host-side in
        # SectorArea; the viewer only needs a stable quad)
        c = centroid - (float(np.dot(n, centroid)) - d) * n
        a = np.cross(n, [0.0, 0.0, 1.0])
        if np.linalg.norm(a) < 1e-6:
            a = np.cross(n, [0.0, 1.0, 0.0])
        a = a / np.linalg.norm(a)
        b = np.cross(n, a)
        snap["planes"].append({
            "c": [round(float(v), 4) for v in c],
            "a": [round(float(v), 4) for v in a],
            "b": [round(float(v), 4) for v in b],
        })
    return snap


def render_view3d(path, snapshot=None, bus=None, trajectory=None,
                  live=False, title="pvio_torch 3D map"):
    """Write the interactive viewer HTML. `live=True` embeds a polling
    reload (camera persists across reloads) for use during a run."""
    if snapshot is None:
        snapshot = scene_snapshot(bus=bus, trajectory=trajectory)
    html = _VIEW3D_HTML.replace("__SCENE__", json.dumps(snapshot)) \
                       .replace("__TITLE__", title) \
                       .replace("__LIVE__", "true" if live else "false")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(html)
    os.replace(tmp, path)
    return path


_VIEW3D_HTML = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;background:#10141a;color:#cdd6e3;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:10px;user-select:none}
 #hud b{color:#fff}
 canvas{display:block;cursor:grab}
 .k{color:#8fa3bb}
</style></head><body>
<div id="hud"><b>__TITLE__</b> &nbsp;
 <span class="k">drag</span> orbit &nbsp;<span class="k">wheel</span> zoom
 &nbsp;<span class="k">shift-drag</span> pan &nbsp;<span class="k">r</span> reset
 &nbsp;<span id="stats"></span></div>
<canvas id="cv"></canvas>
<script>
const SCENE = __SCENE__;
const LIVE = __LIVE__;
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
let cam = {yaw:-0.7, pitch:-0.5, dist:14, cx:0, cy:0, cz:0};
try { const s = localStorage.getItem('pvio3d_cam');
      if (s) cam = JSON.parse(s); } catch(e){}
function saveCam(){ try{localStorage.setItem('pvio3d_cam', JSON.stringify(cam));}catch(e){} }
function resize(){ cv.width = innerWidth; cv.height = innerHeight; draw(); }
addEventListener('resize', resize);
function project(p){
  const cy=Math.cos(cam.yaw), sy=Math.sin(cam.yaw);
  const cp=Math.cos(cam.pitch), sp=Math.sin(cam.pitch);
  let x=p[0]-cam.cx, y=p[1]-cam.cy, z=p[2]-cam.cz;
  let x1= cy*x+sy*y, y1=-sy*x+cy*y, z1=z;          // yaw about +z
  let y2= cp*y1+sp*z1, z2=-sp*y1+cp*z1;            // pitch about +x
  const zc = y2 + cam.dist;                        // view depth
  if (zc < 0.05) return null;
  const f = 0.9*Math.min(cv.width, cv.height);
  return [cv.width/2 + f*x1/zc, cv.height/2 - f*z2/zc, zc];
}
function line(a, b, style, w){
  const pa=project(a), pb=project(b);
  if(!pa||!pb) return;
  ctx.strokeStyle=style; ctx.lineWidth=w||1;
  ctx.beginPath(); ctx.moveTo(pa[0],pa[1]); ctx.lineTo(pb[0],pb[1]); ctx.stroke();
}
function draw(){
  ctx.fillStyle='#10141a'; ctx.fillRect(0,0,cv.width,cv.height);
  // ground grid
  for(let i=-5;i<=5;i++){
    line([i,-5,0],[i,5,0],'#1d2633',1); line([-5,i,0],[5,i,0],'#1d2633',1);
  }
  line([0,0,0],[1,0,0],'#c0504d',2); line([0,0,0],[0,1,0],'#5a9a4e',2);
  line([0,0,0],[0,0,1],'#4e7ab8',2);
  // planes
  for(const pl of SCENE.planes){
    const c=pl.c,a=pl.a,b=pl.b,S=1.5;
    const q=[[-S,-S],[S,-S],[S,S],[-S,S]].map(uv=>
      [c[0]+uv[0]*a[0]+uv[1]*b[0], c[1]+uv[0]*a[1]+uv[1]*b[1],
       c[2]+uv[0]*a[2]+uv[1]*b[2]]);
    const pp=q.map(project);
    if(pp.every(v=>v)){
      ctx.fillStyle='rgba(90,150,220,0.13)'; ctx.strokeStyle='rgba(110,170,240,0.6)';
      ctx.beginPath(); ctx.moveTo(pp[0][0],pp[0][1]);
      for(let i=1;i<4;i++) ctx.lineTo(pp[i][0],pp[i][1]);
      ctx.closePath(); ctx.fill(); ctx.stroke();
    }
    for(let i=-2;i<3;i++){
      line([c[0]+i*0.75*a[0]-S*b[0],c[1]+i*0.75*a[1]-S*b[1],c[2]+i*0.75*a[2]-S*b[2]],
           [c[0]+i*0.75*a[0]+S*b[0],c[1]+i*0.75*a[1]+S*b[1],c[2]+i*0.75*a[2]+S*b[2]],
           'rgba(110,170,240,0.25)');
    }
  }
  // landmarks (painter-sorted, depth-shaded)
  const pts = SCENE.landmarks.map(p=>({p:project(p)})).filter(o=>o.p);
  pts.sort((u,v)=>v.p[2]-u.p[2]);
  for(const o of pts){
    const s = Math.max(1.2, 5.5/Math.sqrt(o.p[2]));
    const c = Math.max(90, 235 - 12*o.p[2]);
    ctx.fillStyle=`rgb(${c*0.55},${c*0.9},${c*0.6})`;
    ctx.fillRect(o.p[0]-s/2, o.p[1]-s/2, s, s);
  }
  // trajectory
  ctx.strokeStyle='#e8b33c'; ctx.lineWidth=1.6; ctx.beginPath();
  let started=false;
  for(const p of SCENE.trajectory){
    const pp=project(p); if(!pp){started=false;continue;}
    if(!started){ctx.moveTo(pp[0],pp[1]);started=true;} else ctx.lineTo(pp[0],pp[1]);
  }
  ctx.stroke();
  // keyframe frusta
  for(const fr of SCENE.frusta){
    const p=fr.p, R=fr.R, s=0.22;
    const corner=(u,v)=>[p[0]+R[0][0]*u*s+R[0][1]*v*s+R[0][2]*2*s,
                         p[1]+R[1][0]*u*s+R[1][1]*v*s+R[1][2]*2*s,
                         p[2]+R[2][0]*u*s+R[2][1]*v*s+R[2][2]*2*s];
    const cs=[corner(-1,-1),corner(1,-1),corner(1,1),corner(-1,1)];
    for(const c of cs) line(p,c,'#d06c9c',1.2);
    for(let i=0;i<4;i++) line(cs[i],cs[(i+1)%4],'#d06c9c',1.2);
  }
  document.getElementById('stats').textContent =
    `${SCENE.landmarks.length} landmarks, ${SCENE.frusta.length} keyframes, `+
    `${SCENE.planes.length} planes, ${SCENE.trajectory.length} poses`;
}
let drag=null;
cv.addEventListener('mousedown', e=>{drag={x:e.clientX,y:e.clientY,shift:e.shiftKey};cv.style.cursor='grabbing';});
addEventListener('mouseup', ()=>{drag=null;cv.style.cursor='grab';saveCam();});
addEventListener('mousemove', e=>{
  if(!drag) return;
  const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
  drag.x=e.clientX; drag.y=e.clientY;
  if(drag.shift){
    const k=cam.dist/600, cy=Math.cos(cam.yaw), sy=Math.sin(cam.yaw);
    cam.cx -= k*(dx*cy); cam.cy -= k*(-dx*sy); cam.cz += k*dy;
  } else { cam.yaw += dx*0.008; cam.pitch = Math.max(-1.55, Math.min(1.55, cam.pitch - dy*0.008)); }
  draw();
});
cv.addEventListener('wheel', e=>{e.preventDefault();
  cam.dist=Math.max(0.5,Math.min(200,cam.dist*Math.exp(e.deltaY*0.0012)));
  draw(); saveCam();});
addEventListener('keydown', e=>{ if(e.key==='r'){
  cam={yaw:-0.7,pitch:-0.5,dist:14,cx:0,cy:0,cz:0}; draw(); saveCam();}});
if (LIVE) setInterval(()=>{saveCam(); location.reload();}, 2000);
resize();
</script></body></html>
"""
