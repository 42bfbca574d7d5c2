"""Binary FBX reader and minimal writer: the input layer of the stage-3
renders.

A copy of ``drawingspinup_tpu/render/fbx.py`` (numpy, struct and zlib only);
``tests/test_torch_render.py`` pins it to the original by the scene arrays
it reads from one file and by the bytes it writes. It reads the binary FBX
7.x container (node records with u32/u64 offsets by version; typed
properties: Y, C, I, F, D, L scalars, f, d, l, i, b arrays, zlib-compressed
or raw, S, R blobs) and lifts what a skeletal animation needs: the mesh
(vertices, triangulated polygons), the model hierarchy with its Lcl
Translation / Rotation / Scaling and PreRotation, the skin clusters
(indexes, weights, Transform and TransformLink bind matrices) and the
animation curves, resolved through the OO and OP connections.
``evaluate_bone_worlds`` samples the curves at frame times and composes
the local transforms (T · Rpre · R · S, XYZ euler) down the hierarchy.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

KTIME_PER_SEC = 46186158000
_MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"


# ---------------------------------------------------------------------------
# low-level container
# ---------------------------------------------------------------------------

@dataclass
class Node:
    name: str
    props: List[Any] = field(default_factory=list)
    children: List["Node"] = field(default_factory=list)

    def find(self, name: str) -> Optional["Node"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name: str) -> List["Node"]:
        return [c for c in self.children if c.name == name]

    def prop(self, i: int = 0, default: Any = None) -> Any:
        return self.props[i] if i < len(self.props) else default


def _read_prop(buf: memoryview, pos: int) -> Tuple[Any, int]:
    code = chr(buf[pos])
    pos += 1
    if code == "Y":
        return struct.unpack_from("<h", buf, pos)[0], pos + 2
    if code == "C":
        return bool(buf[pos]), pos + 1
    if code == "I":
        return struct.unpack_from("<i", buf, pos)[0], pos + 4
    if code == "F":
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if code == "D":
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if code == "L":
        return struct.unpack_from("<q", buf, pos)[0], pos + 8
    if code in "fdlib":
        n, enc, clen = struct.unpack_from("<III", buf, pos)
        pos += 12
        dt = {"f": "<f4", "d": "<f8", "l": "<i8", "i": "<i4", "b": "<b"}[code]
        if enc == 0:
            itemsize = np.dtype(dt).itemsize
            raw = bytes(buf[pos: pos + n * itemsize])
            pos += n * itemsize
        else:
            raw = zlib.decompress(bytes(buf[pos: pos + clen]))
            pos += clen
        return np.frombuffer(raw, dtype=dt).copy(), pos
    if code == "S":
        n = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        s = bytes(buf[pos: pos + n])
        pos += n
        return s.decode("utf-8", errors="replace"), pos
    if code == "R":
        n = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        r = bytes(buf[pos: pos + n])
        return r, pos + n
    raise ValueError(f"unknown FBX property code {code!r} at {pos}")


def _read_node(buf: memoryview, pos: int, long_offsets: bool
               ) -> Tuple[Optional[Node], int]:
    if long_offsets:
        end, n_props, _plen = struct.unpack_from("<QQQ", buf, pos)
        pos += 24
    else:
        end, n_props, _plen = struct.unpack_from("<III", buf, pos)
        pos += 12
    name_len = buf[pos]
    pos += 1
    if end == 0 and n_props == 0 and name_len == 0:
        return None, pos
    name = bytes(buf[pos: pos + name_len]).decode("utf-8", errors="replace")
    pos += name_len
    node = Node(name)
    for _ in range(n_props):
        p, pos = _read_prop(buf, pos)
        node.props.append(p)
    while pos < end:
        child, pos = _read_node(buf, pos, long_offsets)
        if child is None:
            break
        node.children.append(child)
    return node, max(pos, end)


def parse_fbx(path: str) -> Tuple[List[Node], int]:
    """Parse the binary container → (top-level nodes, version)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:len(_MAGIC)] == _MAGIC, "not a binary FBX file"
    version = struct.unpack_from("<I", data, 23)[0]
    long_offsets = version >= 7500
    buf = memoryview(data)
    pos = 27
    roots: List[Node] = []
    while pos < len(data):
        node, pos = _read_node(buf, pos, long_offsets)
        if node is None:
            break
        roots.append(node)
    return roots, version


def _props70(node: Node) -> Dict[str, List[Any]]:
    out: Dict[str, List[Any]] = {}
    p70 = node.find("Properties70")
    if p70:
        for p in p70.find_all("P"):
            out[p.prop(0)] = p.props[4:]
    return out


# ---------------------------------------------------------------------------
# scene model
# ---------------------------------------------------------------------------

@dataclass
class FbxModel:
    uid: int
    name: str
    kind: str                           # Mesh | LimbNode | Null | ...
    translation: np.ndarray
    rotation: np.ndarray                # euler deg
    scaling: np.ndarray
    pre_rotation: np.ndarray            # euler deg
    parent: Optional[int] = None


@dataclass
class FbxCluster:
    bone_model: int
    indexes: np.ndarray
    weights: np.ndarray
    transform: np.ndarray               # (4,4) mesh world at bind
    transform_link: np.ndarray          # (4,4) bone world at bind


@dataclass
class FbxAnimCurve:
    times: np.ndarray                   # seconds
    values: np.ndarray


@dataclass
class FbxScene:
    vertices: np.ndarray                # (V, 3) rest mesh
    faces: np.ndarray                   # (F, 3)
    models: Dict[int, FbxModel]
    mesh_model: Optional[int]
    clusters: List[FbxCluster]
    # anim[model_uid]["Lcl Translation"|"Lcl Rotation"]["X"|"Y"|"Z"]
    anim: Dict[int, Dict[str, Dict[str, FbxAnimCurve]]]
    frame_rate: float = 30.0

    def frame_range(self) -> Tuple[float, float]:
        lo, hi = np.inf, -np.inf
        for chans in self.anim.values():
            for axes in chans.values():
                for c in axes.values():
                    if len(c.times):
                        lo = min(lo, c.times[0])
                        hi = max(hi, c.times[-1])
        if not np.isfinite(lo):
            return 0.0, 0.0
        return float(lo), float(hi)


def _triangulate(poly_idx: np.ndarray) -> np.ndarray:
    faces = []
    cur: List[int] = []
    for v in poly_idx:
        if v < 0:
            cur.append(~int(v))
            for k in range(1, len(cur) - 1):
                faces.append([cur[0], cur[k], cur[k + 1]])
            cur = []
        else:
            cur.append(int(v))
    return np.asarray(faces, np.int64) if faces else np.zeros((0, 3), np.int64)


def load_scene(path: str) -> FbxScene:
    roots, _version = parse_fbx(path)
    by_name = {n.name: n for n in roots}
    objects = by_name.get("Objects", Node("Objects"))
    connections = by_name.get("Connections", Node("Connections"))

    # connections: child → parent (OO) and child → (parent, property) (OP)
    oo: List[Tuple[int, int]] = []
    op: List[Tuple[int, int, str]] = []
    for c in connections.find_all("C"):
        kind = c.prop(0)
        if kind == "OO":
            oo.append((c.prop(1), c.prop(2)))
        elif kind == "OP":
            op.append((c.prop(1), c.prop(2), c.prop(3)))

    models: Dict[int, FbxModel] = {}
    geoms: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    clusters_raw: Dict[int, Node] = {}
    curves: Dict[int, FbxAnimCurve] = {}
    curve_nodes: Dict[int, Dict[str, float]] = {}

    for obj in objects.children:
        uid = obj.prop(0)
        if obj.name == "Model":
            p = _props70(obj)
            def vec(key, default):
                v = p.get(key)
                return np.asarray(v[:3], np.float64) if v else \
                    np.asarray(default, np.float64)
            kind = obj.prop(2, "")
            models[uid] = FbxModel(
                uid=uid, name=str(obj.prop(1, "")), kind=str(kind),
                translation=vec("Lcl Translation", [0, 0, 0]),
                rotation=vec("Lcl Rotation", [0, 0, 0]),
                scaling=vec("Lcl Scaling", [1, 1, 1]),
                pre_rotation=vec("PreRotation", [0, 0, 0]))
        elif obj.name == "Geometry":
            v = obj.find("Vertices")
            i = obj.find("PolygonVertexIndex")
            if v is not None and i is not None:
                verts = np.asarray(v.prop(0), np.float64).reshape(-1, 3)
                faces = _triangulate(np.asarray(i.prop(0)))
                geoms[uid] = (verts.astype(np.float32), faces)
        elif obj.name == "Deformer" and obj.prop(2) == "Cluster":
            clusters_raw[uid] = obj
        elif obj.name == "AnimationCurve":
            t = obj.find("KeyTime")
            val = obj.find("KeyValueFloat")
            if t is not None and val is not None:
                curves[uid] = FbxAnimCurve(
                    times=np.asarray(t.prop(0), np.float64) / KTIME_PER_SEC,
                    values=np.asarray(val.prop(0), np.float64))
        elif obj.name == "AnimationCurveNode":
            p = _props70(obj)
            curve_nodes[uid] = {k.split("|")[-1]: (v[0] if v else 0.0)
                                for k, v in p.items() if k.startswith("d|")}

    # model hierarchy: only model→model OO links count (a bone is also an OO
    # child of its skin Cluster — that must not clobber its parent)
    for child, parent in oo:
        if child in models and parent in models:
            models[child].parent = parent

    # geometry → its model
    mesh_model = None
    vertices = np.zeros((0, 3), np.float32)
    faces = np.zeros((0, 3), np.int64)
    for child, parent in oo:
        if child in geoms and parent in models:
            mesh_model = parent
            vertices, faces = geoms[child]
            break
    if mesh_model is None and geoms:
        vertices, faces = next(iter(geoms.values()))

    # clusters → bone models
    clusters: List[FbxCluster] = []
    for cuid, cnode in clusters_raw.items():
        bone = None
        for child, parent in oo:
            if parent == cuid and child in models:
                bone = child
                break
        if bone is None:
            continue
        idx = cnode.find("Indexes")
        wts = cnode.find("Weights")
        tr = cnode.find("Transform")
        tl = cnode.find("TransformLink")
        clusters.append(FbxCluster(
            bone_model=bone,
            indexes=np.asarray(idx.prop(0), np.int64) if idx is not None
            else np.zeros(0, np.int64),
            weights=np.asarray(wts.prop(0), np.float64) if wts is not None
            else np.zeros(0),
            transform=np.asarray(tr.prop(0), np.float64).reshape(4, 4).T
            if tr is not None else np.eye(4),
            transform_link=np.asarray(tl.prop(0), np.float64).reshape(4, 4).T
            if tl is not None else np.eye(4)))

    # animation: curve → curve_node (OP channel) → model property (OP)
    curve_of_node: Dict[int, Dict[str, int]] = {}
    node_target: Dict[int, Tuple[int, str]] = {}
    for child, parent, prop in op:
        if child in curves and parent in curve_nodes:
            curve_of_node.setdefault(parent, {})[prop.split("|")[-1]] = child
        elif child in curve_nodes and parent in models:
            node_target[child] = (parent, prop)

    anim: Dict[int, Dict[str, Dict[str, FbxAnimCurve]]] = {}
    for cn_uid, (model_uid, prop) in node_target.items():
        for axis, curve_uid in curve_of_node.get(cn_uid, {}).items():
            anim.setdefault(model_uid, {}).setdefault(prop, {})[axis] = \
                curves[curve_uid]

    frame_rate = 30.0
    gs = by_name.get("GlobalSettings")
    if gs is not None:
        p = _props70(gs)
        if "CustomFrameRate" in p and p["CustomFrameRate"][0] > 0:
            frame_rate = float(p["CustomFrameRate"][0])

    return FbxScene(vertices=vertices, faces=faces, models=models,
                    mesh_model=mesh_model, clusters=clusters, anim=anim,
                    frame_rate=frame_rate)


# ---------------------------------------------------------------------------
# transform evaluation
# ---------------------------------------------------------------------------

def euler_xyz_deg_to_mat(e: np.ndarray) -> np.ndarray:
    """FBX eOrderXYZ: R = Rz @ Ry @ Rx (applied x-first)."""
    rx, ry, rz = np.deg2rad(e)
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _sample(curve: Optional[FbxAnimCurve], t: float, default: float) -> float:
    if curve is None or len(curve.times) == 0:
        return default
    return float(np.interp(t, curve.times, curve.values))


def local_matrix(scene: FbxScene, uid: int, t: float) -> np.ndarray:
    m = scene.models[uid]
    chans = scene.anim.get(uid, {})

    def vec(prop: str, default: np.ndarray) -> np.ndarray:
        axes = chans.get(prop)
        if not axes:
            return default
        return np.array([_sample(axes.get("X"), t, default[0]),
                         _sample(axes.get("Y"), t, default[1]),
                         _sample(axes.get("Z"), t, default[2])])

    tr = vec("Lcl Translation", m.translation)
    rot = vec("Lcl Rotation", m.rotation)
    sc = vec("Lcl Scaling", m.scaling)
    R = euler_xyz_deg_to_mat(m.pre_rotation) @ euler_xyz_deg_to_mat(rot)
    out = np.eye(4)
    out[:3, :3] = R * sc[None, :]
    out[:3, 3] = tr
    return out


def world_matrices(scene: FbxScene, t: float) -> Dict[int, np.ndarray]:
    out: Dict[int, np.ndarray] = {}

    def world(uid: int) -> np.ndarray:
        if uid in out:
            return out[uid]
        m = local_matrix(scene, uid, t)
        parent = scene.models[uid].parent
        w = (world(parent) @ m) if parent is not None else m
        out[uid] = w
        return w

    for uid in scene.models:
        world(uid)
    return out


def evaluate_bone_worlds(scene: FbxScene, times: Sequence[float],
                         bone_uids: Sequence[int]) -> np.ndarray:
    """(T, B, 4, 4) world matrices for the given bones at the given times."""
    out = np.zeros((len(times), len(bone_uids), 4, 4))
    for ti, t in enumerate(times):
        ws = world_matrices(scene, t)
        for bi, uid in enumerate(bone_uids):
            out[ti, bi] = ws[uid]
    return out


# ---------------------------------------------------------------------------
# minimal writer (tests + tooling)
# ---------------------------------------------------------------------------

def _write_prop(out: bytearray, p: Any) -> None:
    if isinstance(p, bool):
        out += b"C" + bytes([1 if p else 0])
    elif isinstance(p, int):
        out += b"L" + struct.pack("<q", p)
    elif isinstance(p, float):
        out += b"D" + struct.pack("<d", p)
    elif isinstance(p, str):
        b = p.encode()
        out += b"S" + struct.pack("<I", len(b)) + b
    elif isinstance(p, bytes):
        out += b"R" + struct.pack("<I", len(p)) + p
    elif isinstance(p, np.ndarray):
        code = {"float32": b"f", "float64": b"d", "int64": b"l",
                "int32": b"i"}[str(p.dtype)]
        raw = p.tobytes()
        out += code + struct.pack("<III", p.size, 0, len(raw)) + raw
    else:
        raise TypeError(f"unsupported fbx writer prop {type(p)}")


def _write_node(out: bytearray, node: Node) -> None:
    start = len(out)
    out += b"\x00" * 24  # placeholder (u64 offsets / version 7500)
    name = node.name.encode()
    out += bytes([len(name)]) + name
    pstart = len(out)
    for p in node.props:
        _write_prop(out, p)
    plen = len(out) - pstart
    if node.children:
        for c in node.children:
            _write_node(out, c)
        out += b"\x00" * 25  # null record terminator
    end = len(out)
    struct.pack_into("<QQQ", out, start, end, len(node.props), plen)


def write_fbx(path: str, roots: List[Node]) -> None:
    """Minimal binary FBX 7500 writer: enough for the synthetic rigs of the
    tests and the smoke run."""
    out = bytearray()
    out += _MAGIC
    out += struct.pack("<I", 7500)
    for n in roots:
        _write_node(out, n)
    out += b"\x00" * 25
    with open(path, "wb") as f:
        f.write(bytes(out))
