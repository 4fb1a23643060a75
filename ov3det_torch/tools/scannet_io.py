"""Raw-ScanNet scan readers: PLY meshes, aggregation/segs JSON, label maps.

A copy of `ov3det/tools/scannet_io.py` (numpy only; the port never
imports the JAX package).

Host-side counterpart of the reference's raw-scan IO layer
(reference 3DOVDet_tools/utils/io_utils.py:1-139), used upstream of this
repo's npz/npy data contract by preprocessing and visualization flows:

- `read_ply_vertices` / `read_ply_vertices_rgb` — vertex xyz (+rgb) from a
  ScanNet `_vh_clean_2.ply` mesh.  Self-contained reader (ascii and
  binary_little_endian, the two formats ScanNet ships) — `plyfile` is not
  a dependency of this repo; parsing is vectorized via numpy structured
  dtypes instead of the reference's per-property copies.
- `read_label_mapping` — `scannetv2-labels.combined.tsv` raw-category ->
  nyu40id (or any column pair).
- `read_aggregation` — `_vh_clean.aggregation.json`: objectId -> segment
  ids (1-indexed instance ids, like the reference) and label -> segment ids.
- `read_segmentation` — `_vh_clean_2.0.010000.segs.json`: segment id ->
  vertex indices, computed with one argsort group-by instead of the
  reference's 200k-iteration python loop.
- `read_axis_alignment` — `axisAlignment` 4x4 from a scene `.txt` meta file.

Frame-level loaders (depth/pose/intrinsic) live in
`ov3det/datasets/image_utils.py` (not ported); PLY *writers* in
`ov3det_torch/utils/visualize.py`.
"""
from __future__ import annotations

import csv
import json
import os

import numpy as np

# PLY scalar type names (both the ply1.0 names and the common C aliases)
_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _parse_ply_header(f):
    """Returns (fmt, elements): elements is an ordered list of
    (name, count, [(prop_name, dtype_char), ...])."""
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        parts = line.decode("ascii", "replace").strip().split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                # list properties (e.g. face vertex_indices) have variable
                # length; vertex elements never use them
                elements[-1][2].append((parts[-1], "list", parts[2], parts[3]))
            else:
                elements[-1][2].append((parts[-1], _PLY_DTYPES[parts[1]]))
        elif parts[0] == "end_header":
            return fmt, elements


def _read_ply_element(f, fmt, name, count, props, skip_preceding):
    """Read one element's rows as a numpy structured array.  Only fixed-size
    (non-list) elements are supported — vertices always are."""
    for pname, pcount, pprops in skip_preceding:
        if any(len(p) == 4 for p in pprops):
            raise ValueError(
                f"cannot skip list-typed element {pname!r} before {name!r}"
            )
        row = np.dtype([(n, d) for n, d in pprops])
        if fmt == "ascii":
            for _ in range(pcount):
                f.readline()
        else:
            f.seek(pcount * row.itemsize, os.SEEK_CUR)
    if any(len(p) == 4 for p in props):
        raise ValueError(f"element {name!r} has list properties")
    dtype = np.dtype([(n, d) for n, d in props])
    if fmt == "ascii":
        rows = np.loadtxt(f, dtype=np.float64, max_rows=count, ndmin=2)
        out = np.empty(count, dtype=dtype)
        for j, (n, _) in enumerate(props):
            out[n] = rows[:, j]
        return out
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt!r}")
    buf = f.read(count * dtype.itemsize)
    return np.frombuffer(buf, dtype=dtype, count=count)


def _read_vertices(filename: str, fields):
    with open(filename, "rb") as f:
        fmt, elements = _parse_ply_header(f)
        preceding = []
        for name, count, props in elements:
            if name == "vertex":
                v = _read_ply_element(f, fmt, name, count, props, preceding)
                return np.stack(
                    [v[k].astype(np.float32) for k in fields], axis=1
                )
            preceding.append((name, count, props))
    raise ValueError(f"no vertex element in {filename}")


def read_ply_vertices(filename: str) -> np.ndarray:
    """(N, 3) float32 xyz (reference io_utils.read_mesh_vertices)."""
    return _read_vertices(filename, ("x", "y", "z"))


def read_ply_vertices_rgb(filename: str):
    """((N, 3) xyz, (N, 3) rgb) float32
    (reference io_utils.read_mesh_vertices_rgb)."""
    v = _read_vertices(filename, ("x", "y", "z", "red", "green", "blue"))
    return v[:, :3], v[:, 3:]


def _represents_int(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


def read_label_mapping(filename: str, label_from: str = "raw_category",
                       label_to: str = "nyu40id") -> dict:
    """TSV column map, e.g. raw category name -> nyu40 id
    (reference io_utils.read_label_mapping: int values; keys become int when
    the source column is numeric)."""
    mapping = {}
    with open(filename, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            mapping[row[label_from]] = int(row[label_to])
    if mapping and _represents_int(next(iter(mapping))):
        mapping = {int(k): v for k, v in mapping.items()}
    return mapping


def read_aggregation(filename: str):
    """`.aggregation.json` -> (object_id_to_segs, label_to_segs); instance
    ids are 1-indexed like the reference (io_utils.read_aggregation)."""
    with open(filename) as f:
        data = json.load(f)
    object_id_to_segs, label_to_segs = {}, {}
    for grp in data["segGroups"]:
        object_id = grp["objectId"] + 1
        segs = list(grp["segments"])
        object_id_to_segs[object_id] = segs
        label_to_segs.setdefault(grp["label"], []).extend(segs)
    return object_id_to_segs, label_to_segs


def read_segmentation(filename: str):
    """`.segs.json` -> (seg_to_verts, num_verts).  One argsort group-by over
    the ~200k-entry segIndices array instead of the reference's per-vertex
    python loop (io_utils.read_segmentation) — same dict contract."""
    with open(filename) as f:
        seg_ids = np.asarray(json.load(f)["segIndices"], dtype=np.int64)
    order = np.argsort(seg_ids, kind="stable")
    uniq, starts = np.unique(seg_ids[order], return_index=True)
    groups = np.split(order, starts[1:])
    seg_to_verts = {int(s): g.tolist() for s, g in zip(uniq, groups)}
    return seg_to_verts, int(seg_ids.size)


def read_axis_alignment(meta_file: str) -> np.ndarray:
    """Scene meta `.txt` -> (4, 4) axisAlignment matrix
    (reference io_utils.read_alignment)."""
    with open(meta_file) as f:
        for line in f:
            if "axisAlignment" in line:
                vals = line.rstrip().split("=", 1)[1].split()
                return np.asarray(vals, dtype=np.float64).reshape(4, 4)
    raise ValueError(f"no axisAlignment entry in {meta_file}")
