"""Minimal OpenEXR scanline reader and writer (pure Python + zlib).

A copy of ``xrdslam_tpu/utils/exr.py``, carried because importing that
package loads its accelerator framework. The reference reads CoFusion's
depth maps with cv2's EXR support; this module implements the subset the
datasets need without an OpenEXR binding: single-part scanline images,
NONE / ZIPS / ZIP compression, HALF / FLOAT / UINT channels. Spec:
https://openexr.com/en/latest/OpenEXRFileLayout.html.

``read_exr(path)`` returns a dict {channel: [H, W] float32};
``read_exr_depth`` collapses to a single depth array (prefers Z/R/Y).
``write_exr`` (NONE compression, FLOAT) writes test and tooling files.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = 0x01312F76
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP = 0, 1, 2, 3
_SCANLINES_PER_BLOCK = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}


def _read_cstr(buf: bytes, pos: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _parse_channels(data: bytes) -> List[Tuple[str, int]]:
    chans = []
    pos = 0
    while data[pos] != 0:
        name, pos = _read_cstr(data, pos)
        ptype = struct.unpack_from("<i", data, pos)[0]
        pos += 16  # pixelType + pLinear/reserved + xSampling + ySampling
        chans.append((name, ptype))
    return chans


def _unpredict(d: bytearray) -> bytes:
    """EXR zip reconstruction: delta-decode then de-interleave."""
    arr = np.frombuffer(bytes(d), np.uint8).astype(np.int64)
    # out[0] = arr[0]; out[i] = out[i-1] + arr[i] - 128  (ImfZip.cpp)
    arr = (np.cumsum(arr - 128) + 128) % 256
    arr = arr.astype(np.uint8)
    out = np.empty_like(arr)
    half = (len(arr) + 1) // 2
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out.tobytes()


def read_exr(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<iI", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    if version & 0x200:
        raise NotImplementedError("multi-part EXR not supported")
    pos = 8
    attrs: Dict[str, bytes] = {}
    while True:
        if buf[pos] == 0:
            pos += 1
            break
        name, pos = _read_cstr(buf, pos)
        _, pos = _read_cstr(buf, pos)  # type name
        size = struct.unpack_from("<i", buf, pos)[0]
        pos += 4
        attrs[name] = buf[pos:pos + size]
        pos += size

    chans = _parse_channels(attrs["channels"])  # alphabetical in file order
    comp = attrs["compression"][0]
    if comp not in _SCANLINES_PER_BLOCK:
        raise NotImplementedError(f"EXR compression {comp} not supported")
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"])
    W, H = x1 - x0 + 1, y1 - y0 + 1
    spb = _SCANLINES_PER_BLOCK[comp]
    n_blocks = (H + spb - 1) // spb

    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, pos)
    out = {name: np.empty((H, W), np.float32) for name, _ in chans}
    bytes_per = {_PT_HALF: 2, _PT_FLOAT: 4, _PT_UINT: 4}
    row_bytes = sum(W * bytes_per[t] for _, t in chans)

    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8: off + 8 + size]
        n_lines = min(spb, y1 - y + 1)
        raw_len = row_bytes * n_lines
        if comp in (_COMP_ZIPS, _COMP_ZIP) and size < raw_len:
            data = _unpredict(bytearray(zlib.decompress(data)))
        p = 0
        for line in range(n_lines):
            yy = y - y0 + line
            for name, ptype in chans:
                nb = W * bytes_per[ptype]
                seg = data[p:p + nb]
                p += nb
                if ptype == _PT_HALF:
                    out[name][yy] = np.frombuffer(seg, np.float16).astype(np.float32)
                elif ptype == _PT_FLOAT:
                    out[name][yy] = np.frombuffer(seg, np.float32)
                else:
                    out[name][yy] = np.frombuffer(seg, np.uint32).astype(np.float32)
    return out


def read_exr_depth(path: str) -> np.ndarray:
    """Single-channel depth from an EXR (prefers Z, then R/Y, else first)."""
    chans = read_exr(path)
    for key in ("Z", "R", "Y"):
        if key in chans:
            return chans[key]
    return next(iter(chans.values()))


def write_exr(path: str, channels: Dict[str, np.ndarray]) -> None:
    """Uncompressed FLOAT scanline EXR (testing/tooling)."""
    names = sorted(channels)
    H, W = channels[names[0]].shape

    def attr(name: str, typ: str, data: bytes) -> bytes:
        return (name.encode() + b"\x00" + typ.encode() + b"\x00"
                + struct.pack("<i", len(data)) + data)

    chlist = b""
    for n in names:
        chlist += (n.encode() + b"\x00" + struct.pack("<i", _PT_FLOAT)
                   + b"\x00\x00\x00\x00" + struct.pack("<ii", 1, 1))
    chlist += b"\x00"
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = (
        attr("channels", "chlist", chlist)
        + attr("compression", "compression", b"\x00")
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\x00")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\x00"
    )
    head = struct.pack("<iI", _MAGIC, 2) + header
    table_pos = len(head)
    data_start = table_pos + 8 * H
    rows = []
    offsets = []
    off = data_start
    row_bytes = W * 4 * len(names)
    for y in range(H):
        payload = b"".join(
            np.ascontiguousarray(channels[n][y], np.float32).tobytes()
            for n in names)
        rows.append(struct.pack("<ii", y, row_bytes) + payload)
        offsets.append(off)
        off += 8 + row_bytes
    with open(path, "wb") as f:
        f.write(head)
        f.write(struct.pack(f"<{H}Q", *offsets))
        for r in rows:
            f.write(r)
