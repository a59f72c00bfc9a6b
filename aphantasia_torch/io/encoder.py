"""The image encoders of the frame writer (io/media.py `AsyncFrameWriter`)
and what its encoder processes run.

This module imports numpy, Pillow and the standard library only, never
torch: a spawned encoder process imports it, and nothing else of the
package beyond its two `__init__` modules.  `img_save` (io/media.py) and
the encoder processes write through the same `write_image`, so a frame
written either way has the same bytes.

An encoder process (`serve`) maps the writer's ring, a memfd of
frame-sized slots, and takes jobs from its pipe: a slot's offset, the
frame's shape and dtype, the file's path and a tone map.  It applies
`to_uint8` and the tone map, writes the file aside and renames it, and
answers with the slot, the encode's `time.perf_counter_ns()` interval and
the error, if any.  A tone map crosses the pipe pickled: a module-level
function, or a `functools.partial` of one with its arguments (`gamma_tone`,
`depth_tone`).
"""
from __future__ import annotations

import mmap
import os
import threading
import time

import numpy as np

PIL_FORMATS = {".jpg": "JPEG", ".jpeg": "JPEG", ".png": "PNG",
               ".bmp": "BMP", ".tif": "TIFF", ".ppm": "PPM"}


def to_uint8(img) -> np.ndarray:
    """img_save's normalisation: a float image in [0,1] -> uint8 (clipped);
    an integer image passes through."""
    img = np.asarray(img)
    if not np.issubdtype(img.dtype, np.integer):
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return img


def image_format(path) -> str:
    """Pillow's format for the extension of `path` (".jpg" when it has
    none), matched case-insensitively."""
    ext = os.path.splitext(str(path))[1] or ".jpg"
    fmt = PIL_FORMATS.get(ext.lower())
    if fmt is None:
        raise ValueError(f"unsupported image extension {ext!r}")
    return fmt


def write_image(path, img):
    """Encode an HWC uint8 image with Pillow in the format its extension
    names and write it aside, then rename it: the file appears under its
    name only when it is whole (a fleet's rank 0 assembles the frames that
    other hosts write once it sees their names)."""
    from PIL import Image
    fmt = image_format(path)
    part = f"{path}.{os.getpid()}.{threading.get_ident()}.part"
    try:
        Image.fromarray(np.ascontiguousarray(img)).save(part, format=fmt)
        os.replace(part, path)
    except BaseException:
        if os.path.exists(part):
            os.remove(part)
        raise


def gamma_tone(img, power: float) -> np.ndarray:
    """clip_fft's tone maps: (img / 255) ** power * 255, truncated to
    uint8."""
    return ((img / 255.0) ** power * 255).astype(np.uint8)


def depth_tone(arr8, size) -> np.ndarray:
    """illustrip's depth-map JPEG: the uint8 map at the depth model's size
    resized bicubically to the frame's (h, w), as three channels."""
    from PIL import Image
    arr8 = np.asarray(Image.fromarray(arr8).resize((size[1], size[0]),
                                                   Image.BICUBIC))
    return np.stack([arr8] * 3, -1)


class SharedFd:
    """A file descriptor passed to a spawned process as one of its
    arguments: pickled while the process starts, it arrives as the same
    descriptor there."""

    def __init__(self, fd: int):
        self.fd = fd

    def __reduce__(self):
        from multiprocessing import reduction
        return _rebuild_fd, (reduction.DupFd(self.fd),)


def _rebuild_fd(dup) -> int:
    return dup.detach()


def encode_job(ring, job):
    """One job on the mapped ring: (slot, offset, shape, dtype, path,
    tone)."""
    _, offset, shape, dtype, path, tone = job
    img = to_uint8(np.ndarray(shape, np.dtype(dtype), buffer=ring,
                              offset=offset))
    write_image(path, img if tone is None else tone(img))


def _warm():
    """Import Pillow's encoders and run each once, so that a process's
    first frames cost what later ones do (Pillow's first JPEG costs
    ~0.25 s, mostly imports)."""
    import io
    from PIL import Image
    Image.preinit()
    for fmt in ("JPEG", "PNG"):
        Image.new("RGB", (8, 8)).save(io.BytesIO(), format=fmt)


def serve(conn, fd: int, nbytes: int):
    """An encoder process: map the ring (`nbytes` of the memfd `fd`) and
    warm the encoders, then encode each job from `conn` until it sends
    None, answering (slot, t0, t1, error) for each."""
    ring = mmap.mmap(fd, nbytes)
    os.close(fd)
    _warm()
    while True:
        try:
            job = conn.recv()
        except EOFError:
            return
        if job is None:
            return
        t0 = time.perf_counter_ns()
        err = None
        try:
            encode_job(ring, job)
        except Exception as e:      # noqa: BLE001 - reported to the writer
            err = e
        t1 = time.perf_counter_ns()
        try:
            conn.send((job[0], t0, t1, err))
        except Exception:           # noqa: BLE001 - an error that won't pickle
            conn.send((job[0], t0, t1,
                       RuntimeError(f"{type(err).__name__}: {err}")))
