"""HTTP-level integration test for the web viewer (ui/server.py).

The unit tests in test_scene_edit.py pin the panel/rebuild semantics;
this drives the actual HTTP surface the browser talks to — the
window+ImGui replacement (reference ``window.cpp`` + ``renderer.cpp:
659-808``) — with a stub render function so no jit compile is paid:

 * GET  /            page served
 * GET  /schema      settings sections + scene tree JSON
 * POST /input       fly-camera round trip moves the camera
 * POST /set         override lands, visible in the next /schema
 * POST /scene       create/select/destroy round trip; stale ids and
                     bad ops answer 200 instead of dropping the
                     connection (the browser's panel loop must survive)
 * GET  /frame.jpg   JPEG bytes from the render thread
 * GET  /metrics     fps/frame counters flowing
"""
import json
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

from soc_real_time_renderer import scenes
from soc_real_time_renderer.config import RenderConfig
from soc_real_time_renderer.ui import server as server_mod

CFG = RenderConfig(width=16, height=16, shadow_resolution=16,
                   enable_ssao=False, enable_bloom=False,
                   enable_clouds=False, enable_taa=False,
                   enable_auto_exposure=False, enable_hiz=False)


def _stub_render(batch, g, history, mm, nm):
    time.sleep(0.002)            # keep the render thread polite
    color = np.full((3, 16, 16), 0.5, np.float32)
    return types.SimpleNamespace(color=color), history


@pytest.fixture()
def viewer():
    built = scenes.build("helmet", CFG)
    server, state, panel = server_mod.start_server(
        built, _stub_render, history=None, port=0, host="127.0.0.1")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        yield base, state, panel
    finally:
        state.stop = True
        server.shutdown()
        server.server_close()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as r:
        return r.read()


def _post(base, path, body):
    req = urllib.request.Request(base + path,
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read()


def test_viewer_http_roundtrip(viewer):
    base, state, panel = viewer

    # page + schema
    assert b"canvas id=c" in _get(base, "/")
    schema = json.loads(_get(base, "/schema"))
    assert "sun settings" in schema["settings"]
    assert schema["scene"]["roots"]            # helmet entity present

    # fly camera: a forward input must move the camera
    _post(base, "/input", {"dx": 0.0, "dy": 0.0})    # init fly cam
    p0 = np.array(state.built._fly.position, np.float32)
    for _ in range(3):
        _post(base, "/input", {"forward": True, "dx": 0.0, "dy": 0.0})
    p1 = np.array(state.built._fly.position, np.float32)
    assert np.linalg.norm(p1 - p0) > 1e-4

    # settings write-through: override shows up in the next schema read
    _post(base, "/set", {"section": "ssao settings", "name": "bias",
                         "value": 0.125})
    schema = json.loads(_get(base, "/schema"))
    bias = [p for p in schema["settings"]["ssao settings"]
            if p["name"] == "bias"][0]
    assert abs(bias["value"] - 0.125) < 1e-6

    # scene ops: create -> appears in tree; select -> components schema
    n0 = len(schema["scene"]["nodes"])
    _post(base, "/scene", {"op": "create", "name": "http entity"})
    schema = json.loads(_get(base, "/schema"))
    assert len(schema["scene"]["nodes"]) == n0 + 1
    eid = next(int(i) for i, n in schema["scene"]["nodes"].items()
               if n["tag"] == "http entity")
    _post(base, "/scene", {"op": "select", "id": eid})
    schema = json.loads(_get(base, "/schema"))
    assert schema["selected"] == eid
    assert "TagComponent" in schema["components"]

    # robustness: stale ids / unknown ops answer 200 with a JSON body
    assert _post(base, "/scene", {"op": "destroy", "id": 999999}) in (
        b"{}",) or json.loads(_post(base, "/scene",
                                    {"op": "destroy", "id": 999999}))
    _post(base, "/scene", {"op": "add_component", "id": 999999,
                           "type": "MeshComponent"})
    _post(base, "/scene", {"op": "set_property", "id": 999999,
                           "component": "TagComponent", "prop": "tag",
                           "value": "x"})
    _post(base, "/scene", {"op": "no_such_op"})
    # ... and the destroy actually removes the created entity
    _post(base, "/scene", {"op": "destroy", "id": eid})
    schema = json.loads(_get(base, "/schema"))
    assert len(schema["scene"]["nodes"]) == n0
    assert schema["selected"] is None          # selection cleared

    # frames + metrics from the render thread (stub render fn)
    deadline = time.time() + 10.0
    jpg = b""
    while time.time() < deadline and not jpg.startswith(b"\xff\xd8"):
        jpg = _get(base, "/frame.jpg")
        time.sleep(0.05)
    assert jpg.startswith(b"\xff\xd8")         # JPEG magic
    metrics = json.loads(_get(base, "/metrics"))
    assert metrics["frame"] > 1 and metrics["fps"] > 0


def test_viewer_resize(viewer, monkeypatch):
    """POST /resize drives the §3.5 resize path: the render loop swaps
    in a new render fn + history and frames start arriving at the new
    resolution.  make_render_fn is stubbed (per-plan shape-correct
    stub) so the test pins the viewer plumbing, not the jit."""
    import io

    from PIL import Image

    from soc_real_time_renderer.graph import frame as frame_mod

    base, state, panel = viewer

    def _stub_make_render_fn(plan):
        h, w = plan.config.height, plan.config.width

        def fn(batch, g, history, mm, nm):
            time.sleep(0.002)
            return (types.SimpleNamespace(
                color=np.full((3, h, w), 0.5, np.float32)), history)
        return fn

    monkeypatch.setattr(frame_mod, "make_render_fn", _stub_make_render_fn)

    # invalid sizes answer an error without touching the loop
    assert b"error" in _post(base, "/resize", {"width": 100, "height": 64})
    assert b"error" in _post(base, "/resize", {"width": 64})
    assert state.pending_resize is None

    _post(base, "/resize", {"width": 64, "height": 96})
    deadline = time.time() + 15.0
    size = None
    while time.time() < deadline and size != (64, 96):
        jpg = _get(base, "/frame.jpg")
        if jpg.startswith(b"\xff\xd8"):
            size = Image.open(io.BytesIO(jpg)).size      # (w, h)
        time.sleep(0.05)
    assert size == (64, 96)
    assert state.built.plan.config.width == 64
    assert abs(state.built.camera.aspect - 64.0 / 96.0) < 1e-6
