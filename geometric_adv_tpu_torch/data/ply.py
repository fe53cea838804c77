"""Minimal PLY reader/writer for point-cloud vertex data — a copy of
``geometric_adv_tpu/data/ply.py`` (ascii + binary little/big endian; the
``vertex`` element's float properties and optional ``face`` lists), pinned
to it by ``tests/test_torch_imports.py``.
"""

from __future__ import annotations

import numpy as np

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


def _parse_header(f):
    """Parse the header; returns (fmt, byte_order, elements) where elements
    is a list of (name, count, properties) and properties is a list of
    (prop_name, dtype_str) or ('list', count_dtype, item_dtype, name)."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    order = "<"
    elements = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.strip().decode("ascii", errors="replace").split()
        if not tokens or tokens[0] == "comment" or tokens[0] == "obj_info":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
            order = ">" if fmt == "binary_big_endian" else "<"
        elif tokens[0] == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                elements[-1][2].append(("list", tokens[2], tokens[3], tokens[4]))
            else:
                elements[-1][2].append((tokens[2], tokens[1]))
        elif tokens[0] == "end_header":
            break
    if fmt is None:
        raise ValueError("PLY header missing format line")
    return fmt, order, elements


def load_ply(
    file_name: str, with_faces: bool = False, with_color: bool = False
):
    """Load vertex xyz (+faces/colors) from a .ply file.

    Same return convention as the reference loader
    (reference: src/in_out.py:79-99): an [n, 3] float array, or a list
    [points, faces?, color?] when extras are requested.
    """
    with open(file_name, "rb") as f:
        fmt, order, elements = _parse_header(f)
        data = {}
        for name, count, props in elements:
            if fmt == "ascii":
                data[name] = _read_ascii_element(f, count, props)
            else:
                data[name] = _read_binary_element(f, count, props, order)

    vertex = data.get("vertex")
    if vertex is None:
        raise ValueError(f"{file_name}: no vertex element")
    points = np.stack(
        [vertex["x"], vertex["y"], vertex["z"]], axis=1
    ).astype(np.float32)
    ret = [points]
    if with_faces:
        ret.append(np.asarray(data["face"]["vertex_indices"]))
    if with_color:
        ret.append(
            np.stack(
                [vertex["red"], vertex["green"], vertex["blue"]], axis=1
            )
        )
    return ret[0] if len(ret) == 1 else ret


def _read_ascii_element(f, count, props):
    out: dict[str, list] = {}
    scalar_names = [p[0] for p in props if p[0] != "list"]
    list_names = [p[3] for p in props if p[0] == "list"]
    for n in scalar_names + list_names:
        out[n] = []
    for _ in range(count):
        tokens = f.readline().split()
        ti = 0
        for p in props:
            if p[0] == "list":
                ln = int(tokens[ti]); ti += 1
                out[p[3]].append(
                    np.array(tokens[ti : ti + ln], dtype=_PLY_DTYPES[p[2]])
                )
                ti += ln
            else:
                out[p[0]].append(float(tokens[ti])); ti += 1
    return {
        k: (np.asarray(v) if k in scalar_names else v)
        for k, v in out.items()
    }


def _read_binary_element(f, count, props, order):
    if all(p[0] != "list" for p in props):
        dt = np.dtype([(p[0], order + _PLY_DTYPES[p[1]]) for p in props])
        raw = np.frombuffer(f.read(dt.itemsize * count), dtype=dt, count=count)
        return {p[0]: raw[p[0]] for p in props}
    # general (list-bearing) path, row by row
    out: dict[str, list] = {}
    for p in props:
        out[p[3] if p[0] == "list" else p[0]] = []
    for _ in range(count):
        for p in props:
            if p[0] == "list":
                cnt_dt = np.dtype(order + _PLY_DTYPES[p[1]])
                ln = int(
                    np.frombuffer(f.read(cnt_dt.itemsize), dtype=cnt_dt)[0]
                )
                item_dt = np.dtype(order + _PLY_DTYPES[p[2]])
                out[p[3]].append(
                    np.frombuffer(f.read(item_dt.itemsize * ln), dtype=item_dt)
                )
            else:
                dt = np.dtype(order + _PLY_DTYPES[p[1]])
                out[p[0]].append(
                    np.frombuffer(f.read(dt.itemsize), dtype=dt)[0]
                )
    return {
        k: (np.asarray(v) if v and np.isscalar(v[0]) or isinstance(v[0], np.generic) else v)
        for k, v in out.items()
    }


def save_ply(file_name: str, points: np.ndarray, binary: bool = True) -> None:
    """Write an [n, 3] point cloud as a PLY vertex list."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        f"ply\nformat {fmt} 1.0\nelement vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\nend_header\n"
    )
    with open(file_name, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(points.astype("<f4").tobytes())
        else:
            np.savetxt(f, points, fmt="%.9g")
