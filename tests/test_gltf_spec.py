"""glTF spec-conformance regressions for models/gltf.py.

Three loader bugs found by review, each pinned by a minimal asset
constructed in-memory (base64 data URI buffers, like the spec's
embedded form):
 * only the DEFAULT scene is loaded (walking every scene — or seeding
   the DFS with every node when "scenes" is absent — double-loads
   shared/child nodes: duplicated z-fighting geometry);
 * sparse accessor values inherit the PARENT accessor's componentType
   (defaulting to float32 crashed on normalized-u8 sparse values);
 * interleaved bufferViews sized stride*(count-1)+itemsize (spec-legal)
   read without overrun.
"""
import base64
import json

import numpy as np

from soc_real_time_renderer.models import gltf


def _write(tmp_path, doc, name="t.gltf"):
    p = tmp_path / name
    p.write_text(json.dumps(doc))
    return p


def _buf_uri(raw: bytes):
    return "data:application/octet-stream;base64," + \
        base64.b64encode(raw).decode()


def _tri_doc(positions: np.ndarray, extra=None):
    """One mesh with len(positions)//3 triangles, non-indexed."""
    raw = positions.astype(np.float32).tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": _buf_uri(raw), "byteLength": len(raw)}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0,
                         "byteLength": len(raw)}],
        "accessors": [{"bufferView": 0, "componentType": 5126,
                       "count": len(positions), "type": "VEC3"}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
    }
    if extra:
        doc.update(extra)
    return doc


TRI = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
TRI2 = TRI + np.array([2.0, 0, 0], np.float32)


def test_percent_encoded_buffer_uri(tmp_path):
    """glTF 2.0 URIs are percent-encoded: a buffer named
    "scene%20data.bin" must load the on-disk file "scene data.bin"
    (images already did this via unquote; buffers did not)."""
    raw = TRI.astype(np.float32).tobytes()
    (tmp_path / "scene data.bin").write_bytes(raw)
    doc = _tri_doc(TRI, extra={"nodes": [{"mesh": 0}]})
    doc["buffers"] = [{"uri": "scene%20data.bin", "byteLength": len(raw)}]
    m = gltf.load_model(_write(tmp_path, doc))
    assert len(m.triangles) == 1


def test_no_scenes_child_nodes_load_once(tmp_path):
    """No "scenes" key + a root whose child also has a mesh: the child
    must load exactly once (2 triangles, not 3)."""
    doc = _tri_doc(np.concatenate([TRI, TRI2]), extra={
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
        "nodes": [{"mesh": 0, "children": [1]}, {"mesh": 0}],
    })
    m = gltf.load_model(_write(tmp_path, doc))
    assert len(m.triangles) == 2 * 2, len(m.triangles)  # 2 nodes x 2 tris


def test_default_scene_only(tmp_path):
    """Two scenes sharing node 0: only the "scene"-indexed one loads."""
    doc = _tri_doc(np.concatenate([TRI, TRI2]), extra={
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}, {"nodes": [0]}],
        "scene": 1,
    })
    m = gltf.load_model(_write(tmp_path, doc))
    assert len(m.triangles) == 2, len(m.triangles)


def test_sparse_values_inherit_component_type(tmp_path):
    """Sparse values on a normalized-u8 accessor must decode as u8 (the
    float32 default read 4x the bytes and crashed)."""
    base = np.zeros((3, 4), np.uint8)
    sparse_idx = np.array([1], np.uint16)
    sparse_val = np.array([[255, 128, 0, 64]], np.uint8)
    pos_raw = np.concatenate([TRI]).astype(np.float32).tobytes()
    raws = [pos_raw, base.tobytes(), sparse_idx.tobytes(),
            sparse_val.tobytes()]
    off = np.cumsum([0] + [len(r) for r in raws])
    blob = b"".join(raws)
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": _buf_uri(blob), "byteLength": len(blob)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": int(off[i]),
             "byteLength": len(raws[i])} for i in range(4)],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5121, "count": 3,
             "type": "VEC4", "normalized": True,
             "sparse": {"count": 1,
                        "indices": {"bufferView": 2,
                                    "componentType": 5123},
                        "values": {"bufferView": 3}}},
        ],
        "meshes": [{"primitives": [{"attributes": {
            "POSITION": 0, "COLOR_0": 1}}]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
    }
    # COLOR_0 isn't consumed by the renderer, so read the accessor
    # directly: the point is the decode itself
    g = json.loads(_write(tmp_path, doc).read_text())
    buffers = [base64.b64decode(g["buffers"][0]["uri"].split(",", 1)[1])]
    out = gltf._read_accessor(g, buffers, 1)
    np.testing.assert_allclose(out[1], [1.0, 128 / 255, 0.0, 64 / 255],
                               atol=1e-6)
    assert (out[0] == 0).all() and (out[2] == 0).all()


def test_interleaved_view_exact_length(tmp_path):
    """Interleaved view sized stride*(count-1)+itemsize (spec-legal
    minimum) must load without 'buffer smaller than requested'."""
    count, stride = 3, 16          # vec3 f32 (12 bytes) + 4 pad
    raw = bytearray(stride * (count - 1) + 12)
    for i, v in enumerate(TRI):
        raw[i * stride:i * stride + 12] = v.astype(np.float32).tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": _buf_uri(bytes(raw)),
                     "byteLength": len(raw)}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0,
                         "byteLength": len(raw), "byteStride": stride}],
        "accessors": [{"bufferView": 0, "componentType": 5126,
                       "count": count, "type": "VEC3"}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
    }
    m = gltf.load_model(_write(tmp_path, doc))
    assert len(m.triangles) == 1
    np.testing.assert_allclose(np.asarray(m.positions)[:3], TRI)
