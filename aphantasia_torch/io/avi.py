"""Minimal pure-Python MJPEG/AVI muxer.

Fallback video assembly when neither an ffmpeg binary nor a working
cv2.VideoWriter is available (the reference shells out to ffmpeg,
clip_fft.py:312; this keeps video output working in hermetic environments).
MJPEG AVI = RIFF container whose movi chunks are the JPEG frames verbatim.
"""
from __future__ import annotations

import struct


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    data = payload + (b"\x00" if len(payload) % 2 else b"")
    return fourcc + struct.pack("<I", len(payload)) + data


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def write_mjpeg_avi(out_path: str, frame_paths, fps: int = 25) -> str:
    frames = []
    for p in frame_paths:
        with open(p, "rb") as f:
            frames.append(f.read())
    if not frames:
        raise ValueError("no frames")
    # frame dims from JPEG SOF marker
    w, h = _jpeg_size(frames[0])
    n = len(frames)

    avih = struct.pack(
        "<IIIIIIIIIIIIII",
        int(1e6 // fps),    # microseconds per frame
        max(len(f) for f in frames) * fps,  # max bytes/sec (approx)
        0, 0x10,            # padding, flags (HASINDEX)
        n, 0, 1, max(len(f) for f in frames),
        w, h, 0, 0, 0, 0)
    strh = struct.pack(
        "<4s4sIHHIIIIIIIIhhhh",
        b"vids", b"MJPG", 0, 0, 0, 0, 1, fps, 0, n,
        max(len(f) for f in frames), 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                       w * h * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl",
                 _chunk(b"avih", avih) +
                 _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    movi_payload = b"".join(_chunk(b"00dc", f) for f in frames)
    movi = _list(b"movi", movi_payload)
    # idx1 index
    idx = b""
    offset = 4  # offsets relative to 'movi' fourcc
    for f in frames:
        idx += struct.pack("<4sIII", b"00dc", 0x10, offset, len(f))
        offset += 8 + len(f) + (len(f) % 2)
    idx1 = _chunk(b"idx1", idx)
    riff_payload = b"AVI " + hdrl + movi + idx1
    with open(out_path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)
    return out_path


def _jpeg_size(data: bytes):
    """Parse width/height from JPEG SOFn marker."""
    i = 2
    while i < len(data) - 8:
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h, w = struct.unpack(">HH", data[i + 5:i + 9])
            return w, h
        seg_len = struct.unpack(">H", data[i + 2:i + 4])[0]
        i += 2 + seg_len
    raise ValueError("no SOF marker found")
