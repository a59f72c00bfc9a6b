"""Image / frame / video I/O (counterpart of aphantasia_tpu.io.media).

Images are read and encoded with Pillow (io/encoder.py).  Video assembly
tries an ffmpeg binary, then cv2.VideoWriter (mp4v), then the pure-Python
MJPEG/AVI muxer of io/avi.py, so a run never silently loses its frames.
The frame writer (`AsyncFrameWriter`) encodes in processes of its own.
"""
from __future__ import annotations

import collections
import mmap
import multiprocessing
import multiprocessing.connection
import os
import pickle
import shutil
import subprocess
import sys
import types

import numpy as np

from aphantasia_torch.io import encoder
from aphantasia_torch.io.encoder import to_uint8, write_image
from aphantasia_torch.profiling import add_record, span

_IMG_EXTS = ("jpg", "jpeg", "png", "ppm", "tif")


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


def img_save(path, img):
    """Save an HWC image (float in [0,1] or uint8) in the format its
    extension names, matched case-insensitively, written aside and then
    renamed (io/encoder.py `write_image`, as the frame writer's encoder
    processes write)."""
    write_image(path, to_uint8(img))


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


# ---------------------------------------------------------------- frame writer

_STRIDE = 512 << 20      # the ring's bytes a slot may grow to
_SLOTS = 32              # the ring's slots at most


def encoder_count() -> int:
    """A writer's encoder processes: the CPUs this process may use, less
    two (the loop's thread and CUDA's own), from 1 to 4."""
    return max(1, min(4, len(os.sched_getaffinity(0)) - 2))


_ONE_THREAD = ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS")


def _start(procs):
    """Start spawned processes under a bare `__main__`, so that they do not
    run the caller's main module (a CLI's, which imports torch) first, and
    with one BLAS thread each (numpy's import starts a thread a CPU)."""
    main = sys.modules["__main__"]
    env = {k: os.environ.get(k) for k in _ONE_THREAD}
    sys.modules["__main__"] = types.ModuleType("__main__")
    os.environ.update(dict.fromkeys(_ONE_THREAD, "1"))
    try:
        for p in procs:
            p.start()
    finally:
        sys.modules["__main__"] = main
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _np_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    import torch
    return torch.empty((), dtype=dtype).numpy().dtype


def _clear_cuda_error():
    """Reset the last error of the CUDA runtime that torch loaded, which a
    failed registration sets and a later launch check would raise."""
    import ctypes
    with open("/proc/self/maps") as f:
        libs = {line.split()[-1] for line in f if "libcudart" in line}
    for path in libs:
        ctypes.CDLL(path).cudaGetLastError()


class _Slot:
    """A slot of the ring: its offset, the bytes registered with CUDA from
    there (0: none), and a pinned staging buffer where registration
    failed."""

    __slots__ = ("index", "offset", "pinned", "staging")

    def __init__(self, index: int):
        self.index, self.offset = index, index * _STRIDE
        self.pinned, self.staging = 0, None


class AsyncFrameWriter:
    """Frame output off the training loop.  `save()` takes a frame (HWC,
    uint8 or float in [0,1]; a host array or a tensor) and `save_batch()`
    a chunk's stacked frames [N,H,W,3], and both return without waiting
    for the card or an encode.  A pool of encoder processes (spawned when
    the writer is created, `encoder_count()` of them; io/encoder.py, which
    never imports torch) applies img_save's float->uint8 normalisation, the
    optional tone map and Pillow's encode, and writes each file aside and
    renames it: the files are img_save's, byte for byte.  A tone map must
    pickle (io/encoder.py `gamma_tone`, `depth_tone`).

    Frames travel through a ring of frame-sized slots in shared memory (a
    memfd each encoder maps; a slot grows to its largest frame).  A frame
    on the card is one non-blocking copy into a free slot, registered with
    CUDA as pinned memory so that the copy stays asynchronous (where the
    registration fails, into a pinned staging buffer, copied into the slot
    once the copy has landed), plus an event after the admission's copies.
    A slot goes to an encoder only once its event has completed, which
    each later admission checks with `query()`: the caller never waits on
    the card.  The ring grows to `slots` slots (default: 16, or two of the
    largest admission's frames); an admission waits only when every slot
    is taken.  `flush()` and `close()` wait for every frame; both raise
    the first encode error, and `close()` ends the encoder processes.

    Spans: "writer.admit" around `save` and `save_batch`; "writer.wait"
    where an admission blocks for a slot, its value the frames pending on
    entry; "writer.encode" for each frame's encode, from the interval its
    encoder process sends back (`profiling.add_record`)."""

    def __init__(self, encoders: int | None = None, slots: int | None = None):
        n = encoders or encoder_count()
        self._cap = slots
        self._fd = os.memfd_create("frames")
        self._conns, self._procs = [], []
        try:
            os.ftruncate(self._fd, _SLOTS * _STRIDE)
            self._ring = mmap.mmap(self._fd, _SLOTS * _STRIDE)
            ctx = multiprocessing.get_context("spawn")
            theirs = []
            for _ in range(n):
                mine, other = ctx.Pipe()
                self._conns.append(mine)
                theirs.append(other)
                self._procs.append(ctx.Process(
                    target=encoder.serve, name="frame-encoder", daemon=True,
                    args=(other, encoder.SharedFd(self._fd),
                          _SLOTS * _STRIDE)))
            _start(self._procs)
            for other in theirs:
                other.close()
        except BaseException:
            self._shutdown()
            raise
        self._slots: list = []
        self._free: list = []           # free slot indices
        self._staged = collections.deque()   # (job, slot, event)
        self._copied: list = []         # this admission's (job, slot, cuda)
        self._out = [0] * n             # jobs at each encoder
        self._sent = [0] * n
        self._owner: dict = {}          # slot index -> encoder
        self._largest = 0
        self._device = None             # the card of the last copy
        self._error = None
        self._closed = False

    # -- admission

    def save(self, path, frame, tone=None):
        with span("writer.admit"):
            self._admit([path], [frame], tone)

    def save_batch(self, paths, stacked, tone=None):
        """Enqueue a chunk: `stacked` [N,H,W,3] from a chunked dispatch
        (step.py:build_train_loop_frames), one frame for each of
        `paths`."""
        paths = list(paths)
        if paths:
            with span("writer.admit"):
                self._admit(paths, stacked, tone)

    def _pending(self) -> int:
        """Frames admitted and not yet encoded."""
        return len(self._copied) + len(self._staged) + sum(self._out)

    def _admit(self, paths, frames, tone):
        if self._closed:
            raise ValueError("the frame writer is closed")
        self._check_tone(tone)
        self._largest = max(self._largest, len(paths))
        self._collect()
        self._dispatch()
        for i, path in enumerate(paths):
            frame = frames[i]
            cuda = getattr(frame, "is_cuda", False)
            if cuda:
                dtype = _np_dtype(frame.dtype)
            else:
                frame = np.asarray(frame.detach() if hasattr(frame, "detach")
                                   else frame)
                dtype = frame.dtype
            shape = tuple(frame.shape)
            nbytes = int(np.prod(shape)) * dtype.itemsize
            if nbytes > _STRIDE:
                raise ValueError(f"a frame of {nbytes} bytes exceeds the "
                                 f"writer's slots of {_STRIDE}")
            slot = self._take()
            view = np.ndarray(shape, dtype, buffer=self._ring,
                              offset=slot.offset)
            if cuda:
                self._from_card(slot, frame, view, nbytes)
                self._device = frame.device
            else:
                np.copyto(view, frame)
            del view
            self._copied.append(((slot.index, slot.offset, shape, dtype.str,
                                  path, tone), slot, cuda))
        self._stage()
        self._dispatch()

    @staticmethod
    def _check_tone(tone):
        """Refuse, at admission, a tone map that cannot cross to the
        encoders."""
        if tone is None:
            return
        try:
            pickle.dumps(tone)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise TypeError("the frame writer's tone map crosses to its "
                            "encoder processes pickled: pass a module-level "
                            "function or a functools.partial of one "
                            f"({e})") from None

    def _from_card(self, slot, frame, view, nbytes):
        """The non-blocking copy of a CUDA frame into the slot's view (or
        its staging buffer)."""
        import torch
        if slot.staging is None and slot.pinned < nbytes:
            self._pin(slot, nbytes)
        if slot.staging is not None:
            if slot.staging.numel() < nbytes:
                slot.staging = torch.empty(nbytes, dtype=torch.uint8,
                                           pin_memory=True)
            dst = slot.staging[:nbytes].view(frame.dtype).view(frame.shape)
        else:
            dst = torch.from_numpy(view)
        dst.copy_(frame, non_blocking=True)

    def _pin(self, slot, nbytes):
        """Register the slot's first `nbytes` (in whole pages) with CUDA;
        where that fails, give it a staging buffer instead."""
        import torch
        rt = torch.cuda.cudart()
        if slot.pinned:
            rt.cudaHostUnregister(self._addr(slot))
            slot.pinned = 0
        size = -(-nbytes // mmap.PAGESIZE) * mmap.PAGESIZE
        if rt.cudaHostRegister(self._addr(slot), size, 0) == \
                rt.cudaError.success:
            slot.pinned = size
        else:
            _clear_cuda_error()
            slot.staging = torch.empty(0, dtype=torch.uint8)

    def _addr(self, slot) -> int:
        import ctypes
        buf = ctypes.c_char.from_buffer(self._ring, slot.offset)
        try:
            return ctypes.addressof(buf)
        finally:
            del buf

    def _stage(self):
        """This admission's copies so far join the staged frames, those
        from the card behind one event."""
        if not self._copied:
            return
        event = None
        if any(cuda for _, _, cuda in self._copied):
            import torch
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self._device))
        for job, slot, cuda in self._copied:
            self._staged.append((job, slot, event if cuda else None))
        self._copied = []

    def _take(self) -> _Slot:
        """A free slot: a new one while the ring may grow, else one that an
        encoder gives back (a "writer.wait" span)."""
        cap = min(self._cap or max(16, 2 * self._largest), _SLOTS)
        if not self._free and len(self._slots) < cap:
            self._slots.append(_Slot(len(self._slots)))
            self._free.append(len(self._slots) - 1)
        if not self._free:
            with span("writer.wait", self._pending()):
                self._stage()
                while not self._free:
                    self._collect(block=not self._staged)
                    if not self._free and self._staged:
                        self._dispatch(wait=True)
        return self._slots[self._free.pop()]

    # -- to the encoders and back

    def _dispatch(self, wait: bool = False):
        """Send each staged frame whose copy has landed, oldest first; with
        `wait`, wait for the oldest first."""
        while self._staged:
            job, slot, event = self._staged[0]
            if event is not None and not event.query():
                if not wait:
                    return
                event.synchronize()
            wait = False
            self._staged.popleft()
            if slot.staging is not None:
                _, offset, shape, dtype, _, _ = job
                n = int(np.prod(shape)) * np.dtype(dtype).itemsize
                self._ring[offset:offset + n] = slot.staging[:n].numpy()
            w = self._out.index(min(self._out))
            self._conns[w].send(job)
            self._out[w] += 1
            self._sent[w] += 1
            self._owner[slot.index] = w

    def _collect(self, block: bool = False):
        """Take the encoders' answers: free their slots, record their
        encodes, keep the first error.  With `block`, wait for one."""
        if block:
            got = multiprocessing.connection.wait(
                self._conns + [p.sentinel for p in self._procs])
            dead = [p for p in self._procs if p.sentinel in got]
            if dead and not any(c in got for c in self._conns):
                raise RuntimeError(f"a frame encoder process exited with "
                                   f"code {dead[0].exitcode}")
        for w, conn in enumerate(self._conns):
            while self._out[w] and conn.poll():
                index, t0, t1, err = conn.recv()
                del self._owner[index]
                self._out[w] -= 1
                self._free.append(index)
                add_record("writer.encode", t0, t1, self._procs[w].pid)
                if err is not None and self._error is None:
                    self._error = err

    def flush(self):
        """Wait for every frame admitted so far; raise the first error."""
        self._stage()
        while self._staged:
            self._dispatch(wait=True)
        while any(self._out):
            self._collect(block=True)
        err, self._error = self._error, None
        if err is not None:
            raise err

    def close(self):
        if self._closed:
            return
        try:
            self.flush()
        finally:
            self._shutdown()

    def _shutdown(self):
        """End the encoder processes and release the ring."""
        self._closed = True
        sent = getattr(self, "_sent", [0] * len(self._procs))
        for conn in self._conns:
            try:
                conn.send(None)
            except (OSError, ValueError):
                pass
        for p, n in zip(self._procs, sent):
            if p.pid is None:
                continue
            if n == 0:                  # may still be starting: nothing to do
                p.terminate()
            p.join(10)
            if p.exitcode is None:
                p.terminate()
                p.join()
        for conn in self._conns:
            conn.close()
        ring = getattr(self, "_ring", None)
        if ring is not None:
            pinned = [s for s in getattr(self, "_slots", ()) if s.pinned]
            if pinned:
                import torch
                torch.cuda.synchronize(self._device)    # no copy in flight
                rt = torch.cuda.cudart()
                for slot in pinned:
                    rt.cudaHostUnregister(self._addr(slot))
                    slot.pinned = 0
            ring.close()
        os.close(self._fd)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
