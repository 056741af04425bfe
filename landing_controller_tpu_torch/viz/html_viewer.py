"""Interactive 3-D trajectory viewer — the `showmotion` analogue
(spatial_v2/Animation/showmotion.m, SURVEY.md §2.4).

The reference ships a MATLAB OpenGL viewer with camera orbit, play/pause
and a time scrubber.  The solver runs headless, so the equivalent
deliverable is :func:`export_html`: a SELF-CONTAINED html file (no
external assets, vanilla JS + canvas) with the same interactions —
mouse-drag orbit, wheel zoom, play/pause, speed control and a time
slider — rendering the base box, legs and per-foot GRF arrows from a
solved landing trajectory.  Open the file in any browser.

Usage::

    sol = LandingSolver("kinodynamic").solve(q0, qd0)
    export_html("landing.html", sol.X.cpu(), sol.U.cpu(), dt=theta.dt[0].cpu())

Numpy only (the port's copy of the JAX package's viewer, the same page for
the same trajectory).
"""

from __future__ import annotations

import json

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>landing viewer</title><style>
body{margin:0;background:#10151c;color:#cfd8e3;font:13px sans-serif}
#hud{position:fixed;left:10px;top:10px}
#bar{position:fixed;left:10px;bottom:10px;right:10px;display:flex;gap:8px;align-items:center}
input[type=range]{flex:1}
button{background:#2a3442;color:#cfd8e3;border:0;padding:4px 10px;border-radius:3px}
</style></head><body>
<canvas id="c"></canvas><div id="hud"></div>
<div id="bar"><button id="play">&#9658;</button>
<input type="range" id="t" min="0" max="1000" value="0">
<select id="spd"><option value="0.25">0.25x</option><option value="1" selected>1x</option><option value="4">4x</option></select></div>
<script>
const D = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let az = 0.7, el = 0.35, zoom = 420, playing = false, tcur = 0, last = 0;
function resize(){cv.width = innerWidth; cv.height = innerHeight;}
addEventListener('resize', resize); resize();
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY];
onmouseup = () => drag = null;
onmousemove = e => { if(drag){ az += (e.clientX-drag[0])*0.01; el += (e.clientY-drag[1])*0.01;
  el = Math.max(-1.5, Math.min(1.5, el)); drag = [e.clientX, e.clientY]; } };
cv.onwheel = e => { zoom *= Math.exp(-e.deltaY*0.001); e.preventDefault(); };
function proj(p){ // world (x fwd, y left, z up) -> screen, orbit camera
  const ca=Math.cos(az), sa=Math.sin(az), ce=Math.cos(el), se=Math.sin(el);
  const x = ca*p[0]+sa*p[1], y = -sa*p[0]+ca*p[1];
  const u = y, v = -se*x + ce*p[2];
  return [cv.width/2 + zoom*u, cv.height*0.55 - zoom*v];
}
function seg(a,b,col,w){ const A=proj(a),B=proj(b); ctx.strokeStyle=col; ctx.lineWidth=w;
  ctx.beginPath(); ctx.moveTo(A[0],A[1]); ctx.lineTo(B[0],B[1]); ctx.stroke(); }
function R(rpy){ const [r,p,y]=rpy, cr=Math.cos(r),sr=Math.sin(r),cp=Math.cos(p),sp=Math.sin(p),cy=Math.cos(y),sy=Math.sin(y);
  // world-from-body, XYZ convention (rpyToRotMat_xyz transposed)
  const Rx=[[1,0,0],[0,cr,-sr],[0,sr,cr]], Ry=[[cp,0,sp],[0,1,0],[-sp,0,cp]], Rz=[[cy,-sy,0],[sy,cy,0],[0,0,1]];
  const mm=(A,B)=>A.map((r,i)=>B[0].map((_,j)=>r.reduce((s,v,k)=>s+v*B[k][j],0)));
  return mm(Rz,mm(Ry,Rx)); }
function rot(M,p){ return [M[0][0]*p[0]+M[0][1]*p[1]+M[0][2]*p[2],
  M[1][0]*p[0]+M[1][1]*p[1]+M[1][2]*p[2], M[2][0]*p[0]+M[2][1]*p[1]+M[2][2]*p[2]]; }
function lerp(a,b,u){ return a.map((v,i)=>v+(b[i]-v)*u); }
function frameAt(t){ // piecewise-linear in knot time
  const T = D.t; let k = 0;
  while(k < T.length-2 && T[k+1] <= t) k++;
  const u = Math.min(1, Math.max(0, (t-T[k])/(T[k+1]-T[k])));
  return {x: lerp(D.X[k], D.X[k+1], u), u: D.U[Math.min(k, D.U.length-1)]};
}
function draw(){
  const tEnd = D.t[D.t.length-1];
  if(playing){ const now = performance.now();
    tcur += (now-last)/1000 * parseFloat(document.getElementById('spd').value);
    if(tcur > tEnd) tcur = 0; last = now;
    document.getElementById('t').value = 1000*tcur/tEnd; }
  else { tcur = tEnd * document.getElementById('t').value/1000; last = performance.now(); }
  ctx.fillStyle = '#10151c'; ctx.fillRect(0,0,cv.width,cv.height);
  // ground grid
  for(let i=-5;i<=5;i++){ seg([i*0.2,-1,0],[i*0.2,1,0],'#223',1); seg([-1,i*0.2,0],[1,i*0.2,0],'#223',1); }
  const f = frameAt(tcur), com = f.x.slice(0,3), M = R(f.x.slice(3,6));
  // base box (hip rectangle, extruded)
  const hx=D.hip[0], hy=D.hip[1], hz=0.05;
  const cr=[];
  for(const sx of [1,-1]) for(const sy of [1,-1]) for(const sz of [1,-1])
    cr.push([com[0]+rot(M,[sx*hx,sy*hy,sz*hz])[0], com[1]+rot(M,[sx*hx,sy*hy,sz*hz])[1], com[2]+rot(M,[sx*hx,sy*hy,sz*hz])[2]]);
  const eds=[[0,1],[2,3],[4,5],[6,7],[0,2],[1,3],[4,6],[5,7],[0,4],[1,5],[2,6],[3,7]];
  for(const [a,b] of eds) seg(cr[a],cr[b],'#7fb4ff',2);
  // legs: hip -> foot, GRF arrows
  for(let l=0;l<4;l++){
    const sx=[1,1,-1,-1][l], sy=[1,-1,1,-1][l];
    const hip=[com[0]+rot(M,[sx*hx,sy*hy,0])[0],com[1]+rot(M,[sx*hx,sy*hy,0])[1],com[2]+rot(M,[sx*hx,sy*hy,0])[2]];
    const ft=f.u.slice(3*l,3*l+3), gf=f.u.slice(12+3*l,12+3*l+3);
    seg(hip, ft, '#9ad29a', 2.5);
    ctx.fillStyle = '#e3c97f';
    const F0=proj(ft); ctx.beginPath(); ctx.arc(F0[0],F0[1],3,0,7); ctx.fill();
    const s=0.003; seg(ft, [ft[0]+s*gf[0],ft[1]+s*gf[1],ft[2]+s*gf[2]], '#ff8f6b', 2);
  }
  document.getElementById('hud').textContent =
    't = ' + tcur.toFixed(3) + ' s / ' + tEnd.toFixed(3) + ' s   (drag: orbit, wheel: zoom)';
  requestAnimationFrame(draw);
}
document.getElementById('play').onclick = function(){ playing = !playing;
  this.innerHTML = playing ? '&#10074;&#10074;' : '&#9658;'; last = performance.now(); };
draw();
</script></body></html>
"""


def export_html(path, X, U, dt, hip_xy=(0.19, 0.1)):
    """Write a self-contained interactive viewer for one solved trajectory.

    X: (N, 12) base states, U: (N-1, 24) foot positions + GRFs, dt: (N-1,)
    knot durations (the production non-uniform schedule renders with its
    true timing).  hip_xy: body-frame hip half-extents for the base box
    (hipSrbmLocation, get_robot_params.m:50-122).
    """
    X = np.asarray(X, float)
    U = np.asarray(U, float)
    dt = np.asarray(dt, float).reshape(-1)
    t = np.concatenate([[0.0], np.cumsum(dt)])
    data = {
        "t": [round(float(v), 6) for v in t],
        "X": [[round(float(v), 5) for v in row] for row in X],
        "U": [[round(float(v), 5) for v in row] for row in U],
        "hip": [float(hip_xy[0]), float(hip_xy[1])],
    }
    html = _TEMPLATE.replace("__DATA__", json.dumps(data))
    with open(path, "w") as f:
        f.write(html)
    return path
