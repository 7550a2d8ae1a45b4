"""Interactive web viewer — the window/ImGui replacement.

The reference opens a GLFW window with ImGui panels
(``window.{hpp,cpp}``, ``renderer.cpp:659-808``).  Headless GPU hosts
have no display, so the interactive loop is a tiny stdlib HTTP server:

* ``GET /``          — viewer page (canvas + panels, vanilla JS);
* ``GET /frame.jpg`` — latest rendered frame;
* ``POST /input``    — WASD/mouse deltas (ControlledCamera3D input);
* ``GET /schema``    — settings panels + scene hierarchy JSON;
* ``POST /set``      — mutate a ShaderGlobals param (the ImGui slider
  write-through);
* ``POST /scene``    — scene hierarchy mutations (select/create/destroy
  entity, add component, set component property); mesh-set changes
  trigger a live batch rebuild between frames;
* ``POST /resize``   — window resize (SURVEY §3.5: swapchain resize +
  framebuffer recreation + camera.resize), applied between frames;
* ``GET /metrics``   — per-pass timing JSON (the GPUMetric HUD).

Run: ``python tools/viewer.py --scene terrain --port 8000``.
"""
from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html><html><head><title>soc_real_time_renderer</title>
<style>body{background:#111;color:#ddd;font-family:monospace;display:flex;margin:0}
#view{flex:1}#panel{width:340px;overflow-y:auto;height:100vh;padding:8px;background:#1a1a1a}
canvas{width:100%;image-rendering:pixelated}h4{margin:8px 0 2px;color:#8cf}
.row{display:flex;justify-content:space-between;margin:1px 0}
input{width:60px;background:#222;color:#ddd;border:1px solid #444}
#fps{position:fixed;left:8px;top:8px;color:#8f8}</style></head><body>
<div id=view><canvas id=c></canvas><div id=fps></div></div><div id=panel></div>
<script>
const c=document.getElementById('c'),ctx2=c.getContext('2d');
let keys={},mx=0,my=0,drag=false,frames=0,t0=performance.now();
onkeydown=e=>keys[e.key.toLowerCase()]=1;onkeyup=e=>keys[e.key.toLowerCase()]=0;
c.onmousedown=()=>drag=true;onmouseup=()=>drag=false;
c.onmousemove=e=>{if(drag){mx+=e.movementX;my+=e.movementY}};
async function loop(){
 const inp={forward:!!keys['w'],back:!!keys['s'],left:!!keys['a'],right:!!keys['d'],
  up:!!keys[' '],down:!!keys['control'],sprint:!!keys['shift'],dx:mx,dy:my};
 mx=0;my=0;
 try{await fetch('/input',{method:'POST',body:JSON.stringify(inp)})}catch(e){}
 const img=new Image();
 img.onload=()=>{c.width=img.width;c.height=img.height;ctx2.drawImage(img,0,0);
  frames++;const dt=performance.now()-t0;if(dt>1000){
  document.getElementById('fps').innerText=(frames*1000/dt).toFixed(1)+' fps';
  frames=0;t0=performance.now()}
  requestAnimationFrame(loop)};
 // first frames (JIT still compiling) serve an empty body and fire
 // onerror, not onload -- retry instead of halting the loop forever
 img.onerror=()=>setTimeout(loop,500);
 img.src='/frame.jpg?'+Math.random();
}
async function panels(){
 const s=await (await fetch('/schema')).json();const p=document.getElementById('panel');
 p.innerHTML='';
 for(const[sec,props]of Object.entries(s.settings)){
  const h=document.createElement('h4');h.innerText=sec;p.appendChild(h);
  for(const pr of props){
   const row=document.createElement('div');row.className='row';
   const lab=document.createElement('span');lab.innerText=pr.name;row.appendChild(lab);
   const vals=Array.isArray(pr.value)?pr.value:[pr.value];
   vals.forEach((v,i)=>{const inp=document.createElement('input');inp.value=
    typeof v=='number'?v.toPrecision(4):v;
    inp.onchange=async()=>{const nv=vals.map((x,j)=>j==i?parseFloat(inp.value):x);
     await fetch('/set',{method:'POST',body:JSON.stringify({section:sec,
      name:pr.name,value:Array.isArray(pr.value)?nv:nv[0]})})};
    row.appendChild(inp)});
   p.appendChild(row);
  }}
 const rh=document.createElement('h4');rh.innerText='window';p.appendChild(rh);
 const rr=document.createElement('div');rr.className='row';
 const wi=document.createElement('input');wi.value=c.width||1280;
 const hi=document.createElement('input');hi.value=c.height||736;
 const rb=document.createElement('button');rb.innerText='resize';
 rb.onclick=()=>fetch('/resize',{method:'POST',body:JSON.stringify(
  {width:parseInt(wi.value),height:parseInt(hi.value)})});
 rr.appendChild(wi);rr.appendChild(hi);rr.appendChild(rb);p.appendChild(rr);
 const h=document.createElement('h4');h.innerText='scene';p.appendChild(h);
 const sc=async(b)=>{await fetch('/scene',{method:'POST',body:JSON.stringify(b)});panels()};
 const addNode=(id,depth)=>{const n=s.scene.nodes[id];
  const d=document.createElement('div');d.className='row';
  const t=document.createElement('span');
  t.innerText='\\u00a0'.repeat(depth*2)+'\\u2022 '+n.tag;
  if(n.selected)t.style.color='#8cf';
  t.style.cursor='pointer';t.onclick=()=>sc({op:'select',id:id});
  d.appendChild(t);
  const x=document.createElement('span');x.innerText='\\u2715';
  x.style.cursor='pointer';x.onclick=()=>sc({op:'destroy',id:id});
  d.appendChild(x);p.appendChild(d);
  for(const ch of n.children)addNode(ch,depth+1)};
 for(const r of s.scene.roots)addNode(r,0);
 const nb=document.createElement('button');nb.innerText='+ entity';
 nb.onclick=()=>sc({op:'create',name:'new entity'});p.appendChild(nb);
 if(s.selected!=null){
  const ch=document.createElement('h4');ch.innerText='components';p.appendChild(ch);
  for(const[cn,props]of Object.entries(s.components)){
   if(cn=='_addable')continue;
   const hh=document.createElement('div');hh.innerText=cn;hh.style.color='#fc8';
   p.appendChild(hh);
   for(const[pn,tv]of Object.entries(props)){
    const row=document.createElement('div');row.className='row';
    const lab=document.createElement('span');lab.innerText=pn;row.appendChild(lab);
    const vals=Array.isArray(tv[1])?tv[1]:[tv[1]];
    vals.forEach((v,i)=>{const inp=document.createElement('input');
     const isNum=typeof v=='number';
     inp.value=isNum?+v.toPrecision(5):v;
     inp.onchange=()=>{const nv=vals.map((x,j)=>j==i?
       (isNum?parseFloat(inp.value):inp.value):x);
      sc({op:'set_property',id:s.selected,component:cn,prop:pn,
          value:Array.isArray(tv[1])?nv:nv[0]})};
     row.appendChild(inp)});
    p.appendChild(row)}}
  for(const an of (s.components._addable||[])){
   const ab=document.createElement('button');ab.innerText='+ '+an;
   ab.onclick=()=>sc({op:'add_component',id:s.selected,type:an});
   p.appendChild(ab)}}
 const m=document.createElement('pre');m.id='metrics';p.appendChild(m);
 if(!window._mi){window._mi=setInterval(async()=>{const el=
  document.getElementById('metrics');if(!el)return;
  try{el.innerText=JSON.stringify(await (await fetch('/metrics')).json(),null,1)}
  catch(e){}},2000)}
}
panels();loop();
</script></body></html>"""


class ViewerState:
    def __init__(self, built, render_fn, history):
        self.built = built
        self.render_fn = render_fn
        self.history = history
        self.frame_jpeg = b""
        self.frame_index = 1
        self.metrics = {}
        self.overrides = {}
        self.needs_rebuild = False
        # live terrain geometry params pending a host-side re-bake
        # (models/terrain.py: displacement is baked, so terrain_* edits
        # rebuild the terrain model instead of feeding a shader)
        self.terrain_params = {}
        self.terrain_dirty = False
        self.pending_resize = None   # (w, h) requested via POST /resize
        self.stop = False            # render_loop exit flag (tests)
        self.lock = threading.Lock()


def render_loop(state: ViewerState, frames_in_flight: int = 2):
    """The Application::run analog, with frames-in-flight pipelining
    (renderer.cpp:137,646 swapchain analog; VERDICT r2 item 9).

    JAX dispatch is asynchronous: frame N+1 is dispatched BEFORE frame
    N's pixels are read back, so the device-to-host copy and JPEG
    encode overlap the next frame's device compute instead of
    serializing with it.
    Throughput fps then tracks 1000/frame-ms; the extra frame of
    latency is reported separately."""
    from collections import deque
    from ..utils.image_io import to_srgb_u8
    from PIL import Image
    from ..graph import frame as frame_mod
    dt = 1.0 / 60.0
    queue = deque()       # (dispatch_time, outputs) oldest-first
    last_present = time.perf_counter()
    while not state.stop:
        if state.terrain_dirty:
            with state.lock:
                params = dict(state.terrain_params)
                state.terrain_dirty = False
            try:
                if _rebake_terrain(state.built, params):
                    state.needs_rebuild = True
            except Exception:
                import traceback
                traceback.print_exc()
        if state.pending_resize:
            with state.lock:
                w, h = state.pending_resize
                state.pending_resize = None
                cfg = state.built.plan.config
                if (w, h) != (cfg.width, cfg.height):
                    # §3.5: swapchain.resize + recreate_framebuffer +
                    # camera.resize.  In-flight frames have the old
                    # shape — drop them; history targets are recreated
                    # at the new resolution (re-jit is memoized +
                    # persistent-compile-cached on the new plan).
                    queue.clear()
                    state.built.resize(w, h)
                    state.render_fn = frame_mod.make_render_fn(
                        state.built.plan)
                    state.history = frame_mod.RenderHistory.create(
                        state.built.plan.config)
        if state.needs_rebuild:
            with state.lock:
                old_plan = state.built.plan
                old_batch = state.built.batch
                try:
                    state.built.rebuild()     # cheap unless models changed
                except Exception:
                    # a UI-reachable rebuild error must not kill the
                    # render thread — log it and keep serving frames
                    # from the last good state
                    import traceback
                    traceback.print_exc()
                if state.built.batch is not old_batch:
                    queue.clear()             # never present old-batch frames
                if state.built.plan != old_plan:
                    queue.clear()
                    state.render_fn = frame_mod.make_render_fn(
                        state.built.plan)
                    state.history = frame_mod.RenderHistory.create(
                        state.built.plan.config)
                state.needs_rebuild = False
        with state.lock:
            g, mm, nm = state.built.frame_globals(state.frame_index, dt)
            g = _apply_overrides(g, state.overrides)
        outputs, state.history = state.render_fn(
            state.built.batch, g, state.history, mm, nm)
        queue.append((time.perf_counter(), outputs))
        state.frame_index += 1
        if len(queue) < frames_in_flight:
            continue
        t_disp, outs = queue.popleft()
        frame = to_srgb_u8(np.asarray(outs.color))   # sync point (oldest)
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="JPEG", quality=85)
        state.frame_jpeg = buf.getvalue()
        now = time.perf_counter()
        frame_ms = (now - last_present) * 1e3        # throughput
        latency_ms = (now - t_disp) * 1e3            # dispatch->present
        last_present = now
        state.metrics = {"frame_ms": round(frame_ms, 2),
                         "latency_ms": round(latency_ms, 2),
                         "fps": round(1000.0 / max(frame_ms, 1e-3), 1),
                         "frame": state.frame_index,
                         # loud cap telemetry (raster2.OVERFLOW_* bits)
                         # — nonzero means a static cap dropped
                         # fragments this frame
                         "overflow": int(getattr(outs, "overflow", 0))}


def _rebake_terrain(built, params):
    """Re-bake every terrain model in the scene with the live params
    (scale is a vec2; height_scale/midpoint scalars).  Returns True if
    any entity's model changed (the model-identity change routes
    BuiltScene.rebuild onto its full re-pack path)."""
    from .. import scenes
    from ..scene.components import MeshComponent
    kw = {}
    if "height_scale" in params:
        kw["height_scale"] = float(params["height_scale"])
    if "midpoint" in params:
        kw["midpoint"] = float(params["midpoint"])
    if "scale" in params:
        v = params["scale"]
        kw["scale"] = (float(v[0]), float(v[1]))
    changed = False
    for e in built.scene.mesh_entities():
        mc = e.get_component(MeshComponent)
        if getattr(mc.model, "terrain", False):
            mc.model = scenes._terrain_model(**kw)
            changed = True
    return changed


_PARAM_MAP = {
    ("ssao settings", "bias"): "ssao_bias",
    ("ssao settings", "radius"): "ssao_radius",
    ("composition settings", "ambient"): "ambient",
    ("composition settings", "ambient occlusion strength"):
        "ambient_occlussion_strength",
    ("composition settings", "emissive bloom strength"):
        "emissive_bloom_strength",
    ("tone mapping settings", "saturation"): "saturation",
    ("tone mapping settings", "linear section"): "agx_ds_linear_section",
    ("tone mapping settings", "peak"): "peak",
    ("tone mapping settings", "compression"): "compression",
    ("auto exposure settings", "adjustment speed"): "adjustment_speed",
    ("auto exposure settings", "target luminance"): "target_luminance",
    ("bloom settings", "filter radius"): "filter_radius",
    ("depth of field settings", "focal length"): "focal_length",
    ("depth of field settings", "plane in focus"): "plane_in_focus",
    ("depth of field settings", "aperture"): "aperture",
    ("terrain settings", "height scale"): "terrain_height_scale",
    ("terrain settings", "midpoint"): "terrain_midpoint",
    ("terrain settings", "scale"): "terrain_scale",
}

# terrain settings that change baked GEOMETRY (build_terrain_model
# kwargs); the remaining panel rows (delta/min/max depth) are
# tessellation-LOD controls that the reference itself never honours
# (draw_terrain.inl:152-159 sets every level to max_tess_level)
_TERRAIN_GEOM = {
    ("terrain settings", "height scale"): "height_scale",
    ("terrain settings", "midpoint"): "midpoint",
    ("terrain settings", "scale"): "scale",
}

_SUN_MAP = {
    "exponential factor": "exponential_factor",
    "darkening factor": "darkening_factor",
    "bias": "bias",
    "intensity": "intensity",
}


def _apply_overrides(g, overrides):
    import dataclasses
    gkw, skw = {}, {}
    for (section, name), value in overrides.items():
        field = _PARAM_MAP.get((section, name))
        if field:
            gkw[field] = np.asarray(value, np.float32)
        elif section == "sun settings" and name in _SUN_MAP:
            skw[_SUN_MAP[name]] = np.asarray(value, np.float32)
    if skw:
        gkw["sun"] = dataclasses.replace(g.sun, **skw)
    return dataclasses.replace(g, **gkw) if gkw else g


def _jsonable(v):
    """np arrays/scalars in ui_schema values -> plain JSON."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    raise TypeError(type(v))


def make_handler(state: ViewerState, panel):
    from ..camera import InputState
    from . import widgets

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, data, ctype="application/json"):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path.startswith("/frame.jpg"):
                self._send(state.frame_jpeg or b"", "image/jpeg")
            elif self.path.startswith("/schema"):
                with state.lock:
                    # peek: reading the schema must not advance the
                    # prev-camera roll (it would zero one frame's TAA
                    # reprojection velocity per panel refresh)
                    g, _, _ = state.built.frame_globals(state.frame_index,
                                                        peek=True)
                    g = _apply_overrides(g, state.overrides)
                    data = {"settings": widgets.settings_schema(g),
                            "scene": panel.tree(),
                            "selected": panel.selected,
                            "components": (
                                panel.components_schema(panel.selected)
                                if panel.selected is not None else {})}
                self._send(json.dumps(data, default=_jsonable).encode())
            elif self.path.startswith("/metrics"):
                self._send(json.dumps(state.metrics).encode())
            else:
                self._send(_PAGE.encode(), "text/html")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if self.path.startswith("/input"):
                with state.lock:
                    cam = state.built
                    inp = InputState(
                        forward=body.get("forward", False),
                        back=body.get("back", False),
                        left=body.get("left", False),
                        right=body.get("right", False),
                        up=body.get("up", False),
                        down=body.get("down", False),
                        sprint=body.get("sprint", False),
                        cursor_dx=body.get("dx", 0.0),
                        cursor_dy=body.get("dy", 0.0))
                    cam.apply_input(inp, 1.0 / 60.0)
            elif self.path.startswith("/set"):
                with state.lock:
                    state.overrides[(body["section"], body["name"])] = \
                        body["value"]
                    if (body["section"], body["name"]) in _TERRAIN_GEOM:
                        # displacement is baked host-side
                        # (models/terrain.py): a geometry param edit
                        # re-bakes the terrain model between frames.
                        # ("delta"/"min depth"/"max depth" are LOD
                        # controls that are dead in the reference too —
                        # draw_terrain.inl:152-159 forces max tess.)
                        state.terrain_params[
                            _TERRAIN_GEOM[(body["section"],
                                           body["name"])]] = body["value"]
                        state.terrain_dirty = True
                    elif (body["section"] == "sun settings"
                            and body["name"] == "position"):
                        # moving the sun changes projection_view: the
                        # shadow-elision proof must be re-run against
                        # the new matrices (rebuild's cheap path), or
                        # check_sun_proof would reject the frame
                        state.built.set_sun(position=body["value"])
                        state.needs_rebuild = True
            elif self.path.startswith("/resize"):
                # the reference's window-resize path (SURVEY §3.5,
                # window.cpp:29-32 -> renderer.window_resized +
                # camera.resize): validated here, applied by the render
                # loop between frames (swapchain + framebuffer
                # recreation analog)
                try:
                    w, h = int(body["width"]), int(body["height"])
                    if w % 32 or h % 32 or w < 64 or h < 64:
                        raise ValueError(
                            "width/height must be multiples of 32, >= 64")
                except (KeyError, TypeError, ValueError) as e:
                    self._send(json.dumps({"error": str(e)}).encode())
                    return
                with state.lock:
                    state.pending_resize = (w, h)
            elif self.path.startswith("/scene"):
                # scene hierarchy mutations (scene_hiearchy_panel.cpp
                # context-menu ops).  EVERY mutation flags a rebuild,
                # which the render loop applies between frames: a mesh-
                # set change re-packs the batch; anything else takes
                # BuiltScene.rebuild's cheap path (re-bound light scan
                # + shadow-proof re-check against the live transforms —
                # a transform edit can move geometry into the sun
                # volume, and a live-added light must enter the
                # statically-bounded composition scan).  An edit that
                # leaves the plan unchanged costs nothing: make_render_fn
                # is memoized on the plan.
                op = body.get("op")
                with state.lock:
                    try:
                        self._scene_op(op, body)
                    except Exception as e:
                        # a mutation race must answer the request, not
                        # drop the connection and kill the panel loop
                        self._send(json.dumps(
                            {"error": str(e)}).encode())
                        return
            self._send(b"{}")

        def _scene_op(self, op, body):
            if op == "select":
                panel.select(body.get("id"))
            elif op == "create":
                panel.create_entity(body.get("name", "empty entity"))
                state.needs_rebuild = True
            elif op == "destroy":
                if panel.destroy_entity(body["id"]):
                    state.needs_rebuild = True
            elif op == "add_component":
                if panel.add_component(body["id"], body["type"]):
                    state.needs_rebuild = True
            elif op == "set_property":
                if panel.set_property(body["id"], body["component"],
                                      body["prop"], body["value"]):
                    state.needs_rebuild = True

    return Handler


def start_server(built, render_fn, history, port: int = 0,
                 host: str = "0.0.0.0"):
    """Spin up the render thread + HTTP server (not yet serving).
    Returns (server, state, panel); callers drive
    ``server.serve_forever()`` themselves.  ``port=0`` binds an
    ephemeral port (``server.server_address[1]``) — the HTTP
    integration tests use this."""
    from .scene_panel import SceneHiearchyPanel
    from .. import scenes
    state = ViewerState(built, render_fn, history)
    panel = SceneHiearchyPanel(built.scene,
                               model_loader=scenes.default_model)
    t = threading.Thread(target=render_loop, args=(state,), daemon=True)
    t.start()
    server = ThreadingHTTPServer((host, port), make_handler(state, panel))
    return server, state, panel


def serve(built, render_fn, history, port: int = 8000):
    server, _, _ = start_server(built, render_fn, history, port)
    print(f"viewer on http://localhost:{server.server_address[1]}")
    server.serve_forever()
