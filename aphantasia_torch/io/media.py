"""Image / frame / video I/O (counterpart of aphantasia_tpu.io.media).

Images are read and encoded with Pillow.  Video assembly tries an ffmpeg
binary, then cv2.VideoWriter (mp4v), then the pure-Python MJPEG/AVI muxer
of io/avi.py, so a run never silently loses its frames.
"""
from __future__ import annotations

import concurrent.futures
import io
import os
import shutil
import subprocess
import threading

import numpy as np

from aphantasia_torch.profiling import span

_IMG_EXTS = ("jpg", "jpeg", "png", "ppm", "tif")
_PIL_FORMATS = {".jpg": "JPEG", ".jpeg": "JPEG", ".png": "PNG",
                ".bmp": "BMP", ".tif": "TIFF", ".ppm": "PPM"}


def basename(file):
    return os.path.splitext(os.path.basename(file))[0]


def file_list(path, ext=None, subdir=None):
    """Sorted files of `path` (of its tree with `subdir=True`), those
    ending in `ext` (a string), or of the extensions in `ext` (a list)."""
    if subdir is True:
        files = [os.path.join(dp, f) for dp, dn, fn in os.walk(path) for f in fn]
    else:
        files = [os.path.join(path, f) for f in os.listdir(path)]
    if ext is not None:
        if isinstance(ext, list):
            files = [f for f in files
                     if os.path.splitext(f.lower())[1][1:] in ext]
        elif isinstance(ext, str):
            files = [f for f in files if f.endswith(ext)]
    return sorted(f for f in files if os.path.isfile(f))


def img_list(path, subdir=None):
    if subdir is True:
        files = [os.path.join(dp, f) for dp, dn, fn in os.walk(path) for f in fn]
    else:
        files = [os.path.join(path, f) for f in os.listdir(path)]
    files = [f for f in files
             if os.path.splitext(f.lower())[1][1:] in _IMG_EXTS]
    return sorted(f for f in files if os.path.isfile(f))


def img_read(path) -> np.ndarray:
    """Image -> HWC RGB uint8 array."""
    from PIL import Image
    with Image.open(path) as im:
        img = np.asarray(im.convert("RGB") if im.mode not in ("RGB", "L")
                         else im)
    if img.ndim == 2:
        img = np.dstack((img, img, img))
    return img


def to_uint8(img) -> np.ndarray:
    """img_save's normalisation: a float image in [0,1] -> uint8 (clipped);
    an integer image passes through."""
    img = np.asarray(img)
    if not np.issubdtype(img.dtype, np.integer):
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return img


def encode_image_bytes(img, ext: str) -> bytes:
    """In-memory raster encode of an HWC uint8 image; `ext` is matched
    case-insensitively (".JPG" == ".jpg")."""
    from PIL import Image
    fmt = _PIL_FORMATS.get(ext.lower() if ext.startswith(".") else
                           "." + ext.lower())
    if fmt is None:
        raise ValueError(f"unsupported image extension {ext!r}")
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img)).save(buf, format=fmt)
    return buf.getvalue()


def img_save(path, img):
    """Save an HWC image (float in [0,1] or uint8) in the format its
    extension names, matched case-insensitively.  The file appears under
    its name only when it is whole (written aside, then renamed): a fleet's
    rank 0 assembles the frames that other hosts write once it sees their
    names."""
    ext = os.path.splitext(str(path))[1] or ".jpg"
    data = encode_image_bytes(to_uint8(img), ext)
    part = f"{path}.{os.getpid()}.{threading.get_ident()}.part"
    with open(part, "wb") as f:
        f.write(data)
    os.replace(part, path)


def checkout(img, fname=None):
    """A CHW float image in [0,1] (array or tensor) -> an HWC uint8 file
    at `fname` (clipped, scaled by 255 and truncated, as the JAX package's
    `checkout`), written through img_save."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    img = np.transpose(np.asarray(img), (1, 2, 0))
    if fname is not None:
        img_save(fname, np.clip(img * 255, 0, 255).astype(np.uint8))


def frames_to_video(frame_dir: str, out_path: str, pattern: str = "%04d.jpg",
                    fps: int = 25) -> str | None:
    """Assemble numbered JPEG frames into a video: ffmpeg binary ->
    cv2.VideoWriter(mp4) -> MJPEG AVI.  Returns the path written, or None
    when there are no frames."""
    frames = img_list(frame_dir)
    if not frames:
        return None
    if shutil.which("ffmpeg"):
        cmd = ["ffmpeg", "-v", "warning", "-y", "-framerate", str(fps),
               "-i", os.path.join(frame_dir, pattern), out_path]
        if subprocess.run(cmd, check=False).returncode == 0:
            return out_path
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        h, w = img_read(frames[0]).shape[:2]
        vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
        if vw.isOpened():
            for f in frames:
                vw.write(np.ascontiguousarray(img_read(f)[:, :, ::-1]))
            vw.release()
            if os.path.isfile(out_path) and os.path.getsize(out_path) > 0:
                return out_path
    from aphantasia_torch.io.avi import write_mjpeg_avi
    avi_path = os.path.splitext(out_path)[0] + ".avi"
    write_mjpeg_avi(avi_path, frames, fps=fps)
    return avi_path


def _save_frame(path, frame, tone, ready=None):
    if ready is not None:
        ready.synchronize()
    with span("writer.encode"):
        frame = to_uint8(np.asarray(frame))
        img_save(path, frame if tone is None else tone(frame))


class AsyncFrameWriter:
    """Frame output off the training loop: `save()` takes a host array
    (HWC, uint8 or float in [0,1]) and `save_batch()` a chunk's stacked
    frames, and both return at once; a pool of encoder threads applies
    img_save's float->uint8 normalisation, the optional tone map and the
    JPEG encode (Pillow releases the GIL while it compresses), and writes
    the file.  At most `max_pending` frames wait (a whole chunk, when it
    has more); `close()` waits for all of them and raises the first
    error.

    Spans: "writer.admit" around `save` and `save_batch`; "writer.wait"
    where the caller blocks on the oldest frames, its value the frames
    pending on entry; "writer.encode" in the encoder threads (after a
    chunk's copy from the card has landed)."""

    def __init__(self, encoders: int | None = None, max_pending: int = 8):
        n = encoders or max(1, min(4, (os.cpu_count() or 1) - 1))
        self._pool = concurrent.futures.ThreadPoolExecutor(n)
        self._pending: list = []
        self._max = max_pending

    def _drain(self, keep: int):
        """Take the oldest frames' results until `keep` wait; a span
        "writer.wait" only where one of them is not done yet."""
        oldest = self._pending[:max(len(self._pending) - keep, 0)]
        if all(f.done() for f in oldest):
            self._take(keep)
            return
        with span("writer.wait", len(self._pending)):
            self._take(keep)

    def _take(self, keep: int):
        while len(self._pending) > keep:
            self._pending.pop(0).result()

    def save(self, path, frame, tone=None):
        with span("writer.admit"):
            self._drain(self._max - 1)
            self._pending.append(
                self._pool.submit(_save_frame, path, np.asarray(frame), tone))

    def save_batch(self, paths, stacked, tone=None):
        """Enqueue a chunk: `stacked` [N,H,W,3] from a chunked dispatch
        (step.py:build_train_loop_frames), one frame for each of `paths`.
        A chunk on the card is pulled to the host in one non-blocking copy
        into pinned memory, which the encoder threads wait for; the caller
        does not wait."""
        paths = list(paths)
        if paths:
            with span("writer.admit"):
                self._admit(paths, stacked, tone)

    def _admit(self, paths, stacked, tone):
        ready = None
        if getattr(stacked, "is_cuda", False):
            import torch
            host = torch.empty(stacked.shape, dtype=stacked.dtype,
                               pin_memory=True)
            host.copy_(stacked, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            stacked = host
        self._drain(max(self._max - len(paths), 0))
        for i, path in enumerate(paths):
            self._pending.append(self._pool.submit(
                _save_frame, path, stacked[i], tone, ready))

    def flush(self):
        """Wait for every frame enqueued so far; raise the first error."""
        self._drain(0)

    def close(self):
        try:
            self._drain(0)
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
