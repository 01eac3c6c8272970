"""Trained-scene .ply import/export.

Replaces the reference's bulk binary PLY reader
(/root/reference/apps/gsrast/SplatData.cpp:114-156): the reference memcpy-reads
N x RichPoint records (pos 3, normal 3, 48 SH floats, opacity, scale 3, rot
quat 4 = 62 floats; SplatData.hpp:15-25). We parse the same
binary_little_endian layout by named property (robust to SH-degree variants)
into the raw-parameter SoA `GaussianScene` — activations stay explicit
(gaussians.py) instead of being baked in at load (SplatData.cpp:50-54).

A native C++ fast-path reader (native/plyio.cpp) is used when built; the numpy
path is the always-available fallback with identical results.
"""

from __future__ import annotations

import io
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import gaussians as G

_PLY_DTYPES = {
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
    "uchar": np.uint8, "uint8": np.uint8,
    "char": np.int8, "int8": np.int8,
    "ushort": np.uint16, "uint16": np.uint16,
    "short": np.int16, "int16": np.int16,
    "uint": np.uint32, "uint32": np.uint32,
    "int": np.int32, "int32": np.int32,
}


def _parse_header(data: bytes) -> Tuple[int, List[Tuple[str, np.dtype]], int, str]:
    """Returns (vertex_count, [(prop_name, dtype)...], body_offset, format)."""
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError("not a PLY file: no end_header")
    # body starts after the end_header line's newline
    body = data.find(b"\n", end) + 1
    header = data[:end].decode("ascii", errors="replace")
    lines = [ln.strip() for ln in header.splitlines() if ln.strip()]
    if not lines or lines[0] != "ply":
        raise ValueError("not a PLY file: missing magic")
    fmt = "binary_little_endian"
    count = None
    props: List[Tuple[str, np.dtype]] = []
    in_vertex = False
    for ln in lines[1:]:
        if ln.startswith("format"):
            fmt = ln.split()[1]
        elif ln.startswith("element"):
            _, name, cnt = ln.split()
            in_vertex = name == "vertex"
            if in_vertex:
                count = int(cnt)
        elif ln.startswith("property") and in_vertex:
            parts = ln.split()
            if parts[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((parts[2], np.dtype(_PLY_DTYPES[parts[1]])))
    if count is None:
        raise ValueError("no vertex element in PLY header")
    return count, props, body, fmt


def read_ply_raw(path_or_bytes) -> Dict[str, np.ndarray]:
    """Read a PLY vertex element into {property_name: (N,) array}.

    Paths go through the native C++ de-interleaver when built
    (scene/native.py); bytes and unsupported encodings use the numpy path.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        from . import native

        cols = native.read_ply_columns(str(path_or_bytes))
        if cols is not None:
            return cols
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    count, props, body, fmt = _parse_header(data)
    if fmt == "binary_little_endian":
        rec = np.dtype([(n, d.newbyteorder("<")) for n, d in props])
        arr = np.frombuffer(data, dtype=rec, count=count, offset=body)
        return {n: np.ascontiguousarray(arr[n]) for n, _ in props}
    if fmt == "binary_big_endian":
        rec = np.dtype([(n, d.newbyteorder(">")) for n, d in props])
        arr = np.frombuffer(data, dtype=rec, count=count, offset=body)
        return {n: np.ascontiguousarray(arr[n]).astype(arr[n].dtype.newbyteorder("=")) for n, _ in props}
    if fmt == "ascii":
        text = data[body:].decode("ascii")
        vals = np.loadtxt(io.StringIO(text), max_rows=count, ndmin=2)
        return {n: vals[:, i].astype(d) for i, (n, d) in enumerate(props)}
    raise ValueError(f"unsupported PLY format {fmt}")


def _sorted_numeric(names, prefix: str) -> List[str]:
    pat = re.compile(re.escape(prefix) + r"_(\d+)$")
    found = [(int(m.group(1)), n) for n in names if (m := pat.match(n))]
    return [n for _, n in sorted(found)]


def load_ply(path_or_bytes, capacity: Optional[int] = None) -> G.GaussianScene:
    """Load a trained 3DGS .ply into a raw-parameter GaussianScene.

    SH layout note: the on-disk f_rest_0..44 are channel-major ([3, 15]: all
    rest coeffs of R, then G, then B) and are transposed here into
    sh[:, 1:, :]; sh[:, 0, :] is (f_dc_0..2). This matches how downstream
    consumers index SHs<3> (reference SplatData.hpp:9-13).
    """
    raw = read_ply_raw(path_or_bytes)
    n = raw["x"].shape[0]
    means = np.stack([raw["x"], raw["y"], raw["z"]], axis=1).astype(np.float32)
    dc_names = _sorted_numeric(raw, "f_dc")
    rest_names = _sorted_numeric(raw, "f_rest")
    n_rest = len(rest_names)
    if n_rest % 3 != 0:
        raise ValueError(f"f_rest count {n_rest} not divisible by 3")
    k = 1 + n_rest // 3
    sh = np.zeros((n, k, 3), np.float32)
    for c, name in enumerate(dc_names):
        sh[:, 0, c] = raw[name]
    if n_rest:
        rest = np.stack([raw[nm] for nm in rest_names], axis=1).astype(np.float32)
        sh[:, 1:, :] = rest.reshape(n, 3, k - 1).transpose(0, 2, 1)
    scale_names = _sorted_numeric(raw, "scale")
    log_scales = np.stack([raw[nm] for nm in scale_names], axis=1).astype(np.float32)
    rot_names = _sorted_numeric(raw, "rot")
    quats = np.stack([raw[nm] for nm in rot_names], axis=1).astype(np.float32)
    opacity = raw["opacity"].astype(np.float32)
    return G.from_arrays(means, log_scales, quats, opacity, sh, capacity=capacity)


def save_ply(scene: G.GaussianScene, path: str) -> None:
    """Write a GaussianScene back to the standard trained-scene .ply layout
    (inverse of load_ply; raw parameters, normals zeroed as trainers do)."""
    # ONE batched device->host transfer for the whole pytree instead of one
    # per array.
    import jax

    host = jax.device_get(
        (scene.means, scene.mask, scene.log_scales, scene.quats,
         scene.opacity_logits, scene.sh)
    )
    means, mask, log_scales, quats, opacity, sh = map(np.asarray, host)
    means = means[mask]
    log_scales = log_scales[mask]
    quats = quats[mask]
    opacity = opacity[mask]
    sh = sh[mask]
    n, k, _ = sh.shape
    n_rest = (k - 1) * 3

    names = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + [f"f_rest_{i}" for i in range(n_rest)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    rec = np.dtype([(nm, "<f4") for nm in names])
    out = np.zeros(n, rec)
    out["x"], out["y"], out["z"] = means.T
    for i in range(3):
        out[f"f_dc_{i}"] = sh[:, 0, i]
    rest = sh[:, 1:, :].transpose(0, 2, 1).reshape(n, n_rest)
    for i in range(n_rest):
        out[f"f_rest_{i}"] = rest[:, i]
    out["opacity"] = opacity
    for i in range(3):
        out[f"scale_{i}"] = log_scales[:, i]
    for i in range(4):
        out[f"rot_{i}"] = quats[:, i]

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {nm}" for nm in names]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(out.tobytes())
