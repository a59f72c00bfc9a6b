"""AsyncFrameWriter: correctness + byte-bounded back-pressure.

VERDICT r1 item 10: the writer queue must be bounded by BYTES, not item
count — at 4K a 16-item bound could hold ~800MB of pending arrays.
"""
import os
import threading
import time

import numpy as np

from aphantasia_tpu.io.media import AsyncFrameWriter


def test_save_and_save_batch_write_frames(tmp_path):
    rs = np.random.RandomState(0)
    one = rs.randint(0, 255, (32, 48, 3), dtype=np.uint8)
    batch = rs.randint(0, 255, (3, 32, 48, 3), dtype=np.uint8)
    with AsyncFrameWriter() as w:
        w.save(str(tmp_path / "a.jpg"), one)
        w.save_batch([str(tmp_path / ("b%d.jpg" % i)) for i in range(3)],
                     batch)
    names = sorted(os.listdir(tmp_path))
    assert names == ["a.jpg", "b0.jpg", "b1.jpg", "b2.jpg"]


def test_tone_map_applied_in_worker(tmp_path):
    frame = np.full((8, 8, 3), 100, np.uint8)
    seen = []

    def tone(f):
        seen.append(f.copy())
        return np.zeros_like(f)

    with AsyncFrameWriter() as w:
        w.save(str(tmp_path / "t.jpg"), frame, tone)
    assert len(seen) == 1 and seen[0].max() == 100
    from aphantasia_tpu.io.media import img_read
    assert img_read(str(tmp_path / "t.jpg")).max() <= 20  # jpeg-lossy zero


def test_byte_bound_blocks_oversized_backlog(tmp_path):
    """Synthetic 4K chunks: with a ~1.5-chunk byte cap, the third enqueue
    must block until the worker drains one, keeping in-flight bytes under
    cap + one chunk at all times."""
    chunk = np.zeros((2, 2160, 3840, 3), np.uint8)       # ~49.8MB
    cap = int(chunk.nbytes * 1.5)
    release = threading.Event()

    def slow_tone(f):
        release.wait(timeout=30)
        return f

    w = AsyncFrameWriter(cap_bytes=cap)
    peak = []

    def producer():
        for c in range(3):
            w.save_batch(
                [str(tmp_path / ("c%d_%d.jpg" % (c, j))) for j in range(2)],
                chunk, slow_tone)
            with w._cv:
                peak.append(w._inflight)

    t = threading.Thread(target=producer)
    t.start()
    time.sleep(1.0)
    # first chunk admitted + in the worker, second admitted, third blocked
    assert t.is_alive(), "third oversized chunk should be back-pressured"
    with w._cv:
        assert w._inflight <= cap
    release.set()
    t.join(timeout=60)
    assert not t.is_alive()
    w.close()
    assert max(peak) <= cap
    assert len(os.listdir(tmp_path)) == 6


def test_oversized_single_chunk_admitted_when_empty(tmp_path):
    """A single chunk larger than the cap must not deadlock — it is
    admitted when nothing else is in flight."""
    chunk = np.zeros((4, 2160, 3840, 3), np.uint8)       # ~100MB
    with AsyncFrameWriter(cap_bytes=chunk.nbytes // 2) as w:
        w.save_batch(
            [str(tmp_path / ("f%d.jpg" % j)) for j in range(4)], chunk)
    assert len(os.listdir(tmp_path)) == 4


def test_encoder_pool_writes_all_frames_in_order(tmp_path, monkeypatch):
    """r5 (VERDICT item 7): APHANTASIA_WRITER_ENCODERS=3 fans the encode
    stage to a pool feeding one ordered committer.  All frames (batch +
    singles, interleaved) must land with correct content, FIFO order on
    disk (mtime-nondecreasing by sequence), and tone applied per frame."""
    monkeypatch.setenv("APHANTASIA_WRITER_ENCODERS", "3")
    # distinct constant frames: JPEG-robust AND detects any frame<->path
    # swap introduced by the pool
    frames = np.stack([np.full((24, 32, 3), 30 * i, np.uint8)
                       for i in range(6)])
    paths = [str(tmp_path / ("f%d.jpg" % i)) for i in range(8)]
    w = AsyncFrameWriter()
    assert w._n_enc == 3 and len(w._enc_threads) == 3
    w.save(paths[0], np.full((24, 32, 3), 250, np.uint8))
    w.save_batch(paths[1:7], frames)
    w.save(paths[7], frames[5], tone=lambda f: np.zeros_like(f))
    w.close()
    from aphantasia_tpu.io.media import img_read
    assert sorted(os.listdir(tmp_path)) == [f"f{i}.jpg" for i in range(8)]
    assert img_read(paths[0]).mean() > 240
    for i in range(6):                          # no frame<->path swaps
        assert abs(float(img_read(paths[1 + i]).mean()) - 30 * i) < 6, i
    assert img_read(paths[7]).max() <= 20      # tone ran in the pool
    # FIFO commit: sequence order == write order
    times = [os.path.getmtime(p) for p in paths]
    assert times == sorted(times)


def test_encoder_pool_error_propagates(tmp_path, monkeypatch):
    monkeypatch.setenv("APHANTASIA_WRITER_ENCODERS", "2")
    import pytest as _pytest
    w = AsyncFrameWriter()

    def bad_tone(f):
        raise RuntimeError("encode boom")

    w.save(str(tmp_path / "x.jpg"),
           np.zeros((8, 8, 3), np.uint8), tone=bad_tone)
    with _pytest.raises(RuntimeError, match="encode boom"):
        w.close()
    with w._cv:                      # byte budget released despite error
        assert w._inflight == 0


def test_pure_avi_fallback_writes_readable_mjpeg(tmp_path, monkeypatch):
    """The last link of the muxer chain (io/avi.py): with ffmpeg and cv2
    unavailable, frames_to_video writes a pure-Python MJPEG AVI whose RIFF
    structure and frame count check out."""
    import shutil as _shutil
    import struct
    from aphantasia_tpu.io.media import frames_to_video, img_save

    for i in range(3):
        img_save(str(tmp_path / f"{i:04d}.jpg"),
                 np.full((32, 48, 3), 40 * i, np.uint8))
    monkeypatch.setattr(_shutil, "which", lambda *_: None)  # no ffmpeg
    import builtins
    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    out = frames_to_video(str(tmp_path), str(tmp_path / "out.mp4"))
    assert out.endswith(".avi") and os.path.isfile(out)
    data = open(out, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8  # RIFF size
    assert data.count(b"00dc") >= 3      # one video chunk per frame (+index)


def test_frames_to_video_no_frames_returns_none(tmp_path):
    from aphantasia_tpu.io.media import frames_to_video
    assert frames_to_video(str(tmp_path), str(tmp_path / "o.mp4")) is None


# ---------------------------------------------------------------- the port's
# aphantasia_torch.io.media.AsyncFrameWriter: encoder processes over a ring
# of shared-memory slots.  Each writer spawns its processes (~0.5 s), so the
# cases share few writers of one or two encoders.

def _parent_bytes(img, tone=None, fmt="JPEG"):
    """What the writer wrote before its encoders left the interpreter:
    img_save's normalisation, the tone map, Pillow into a BytesIO."""
    import io
    from PIL import Image
    img = np.asarray(img)
    if not np.issubdtype(img.dtype, np.integer):
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if tone is not None:
        img = tone(img)
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img)).save(buf, format=fmt)
    return buf.getvalue()


def test_torch_writer_files_are_the_parents_bytes(tmp_path):
    """A uint8 HWC frame, a float frame (outside [0, 1] too), a save_batch
    chunk (a torch tensor, as a CPU run passes it) and a depth map through
    its tone map: each file holds the bytes the in-process encode gave, and
    img_save writes the same; the encodes come back as "writer.encode"
    records of the encoder processes."""
    import functools
    import multiprocessing
    import torch
    from PIL import Image
    from aphantasia_torch import profiling
    from aphantasia_torch.io import encoder
    from aphantasia_torch.io.media import AsyncFrameWriter as TorchWriter
    from aphantasia_torch.io.media import img_save
    rs = np.random.RandomState(4)
    one = rs.randint(0, 256, (36, 52, 3)).astype(np.uint8)
    flt = (rs.rand(30, 20, 3) * 1.4 - 0.2).astype(np.float32)
    chunk = torch.from_numpy(rs.randint(0, 256, (3, 24, 40, 3))
                             .astype(np.uint8))
    depth = rs.randint(0, 256, (37, 29)).astype(np.uint8)
    size = (48, 64)

    def depth_parent(arr8):        # the closure the depth map had before
        arr8 = np.asarray(Image.fromarray(arr8).resize((size[1], size[0]),
                                                       Image.BICUBIC))
        return np.stack([arr8] * 3, -1)
    start = time.perf_counter_ns()
    with TorchWriter(encoders=2) as w:
        pids = {p.pid for p in w._procs}
        w.save(str(tmp_path / "one.jpg"), one)
        w.save(str(tmp_path / "flt.jpg"), flt)
        w.save_batch([str(tmp_path / f"c{i}.jpg") for i in range(3)], chunk)
        w.save_batch([str(tmp_path / "d.jpg")], depth[None],
                     functools.partial(encoder.depth_tone, size=size))
        w.save(str(tmp_path / "g.png"), one,
               functools.partial(encoder.gamma_tone, power=1.3))
    assert multiprocessing.active_children() == []
    want = {"one.jpg": _parent_bytes(one), "flt.jpg": _parent_bytes(flt),
            "d.jpg": _parent_bytes(depth, depth_parent),
            "g.png": _parent_bytes(
                one, lambda im: ((im / 255.0) ** 1.3 * 255).astype(np.uint8),
                "PNG")}
    want.update({f"c{i}.jpg": _parent_bytes(chunk[i].numpy())
                 for i in range(3)})
    assert sorted(os.listdir(tmp_path)) == sorted(want)
    for name, data in want.items():
        assert (tmp_path / name).read_bytes() == data, name
    img_save(str(tmp_path / "again.jpg"), flt)
    assert (tmp_path / "again.jpg").read_bytes() == want["flt.jpg"]
    encodes = [r for r in profiling.records()
               if r.name == "writer.encode" and r.t0 >= start]
    assert len(encodes) == 7 and {r.process for r in encodes} <= pids
    assert all(r.thread in pids and r.t1 > r.t0 for r in encodes)


def test_torch_writer_waits_only_for_a_slot_of_a_full_ring(tmp_path):
    """A ring of two slots and one encoder: a chunk of three large PNGs
    admits two and waits in "writer.wait" for the first to be encoded (its
    value the two frames pending); a frame admitted after flush() finds a
    free slot and does not wait."""
    from aphantasia_torch.io.media import AsyncFrameWriter as TorchWriter
    from aphantasia_torch.profiling import collect
    frames = np.random.RandomState(5).randint(0, 256, (3, 600, 800, 3),
                                              dtype=np.uint8)
    with TorchWriter(encoders=1, slots=2) as w, collect() as got:
        w.save_batch([str(tmp_path / f"{i}.png") for i in range(3)], frames)
        w.flush()
        w.save(str(tmp_path / "3.png"), frames[0])
    admits = [r for r in got if r.name == "writer.admit"]
    waits = [r for r in got if r.name == "writer.wait"]
    assert len(admits) == 2 and len(waits) == 1
    assert waits[0].parent == admits[0].seq and waits[0].value == 2
    assert len(os.listdir(tmp_path)) == 4


def test_torch_writer_raises_the_first_error_at_close(tmp_path):
    """A frame whose directory does not exist fails in its encoder: the
    other frames are written, close() raises that error, and no encoder
    process is left."""
    import multiprocessing
    import pytest as _pytest
    from aphantasia_torch.io.media import AsyncFrameWriter as TorchWriter
    frame = np.zeros((8, 8, 3), np.uint8)
    w = TorchWriter(encoders=1)
    w.save(str(tmp_path / "a.jpg"), frame)
    w.save(str(tmp_path / "missing" / "b.jpg"), frame)
    w.save(str(tmp_path / "missing" / "c.jpg"), frame)
    w.save(str(tmp_path / "d.jpg"), frame)
    with _pytest.raises(FileNotFoundError, match="b.jpg"):
        w.close()
    assert multiprocessing.active_children() == []
    assert sorted(os.listdir(tmp_path)) == ["a.jpg", "d.jpg"]


def test_torch_writer_leaves_no_process_after_an_exception(tmp_path):
    """An exception inside the writer's block ends its encoders too, and a
    tone map that does not pickle is refused at admission."""
    import multiprocessing
    import pytest as _pytest
    from aphantasia_torch.io.media import AsyncFrameWriter as TorchWriter
    with _pytest.raises(KeyError):
        with TorchWriter(encoders=2) as w:
            w.save(str(tmp_path / "a.jpg"), np.zeros((8, 8, 3), np.uint8))
            raise KeyError("the loop failed")
    assert multiprocessing.active_children() == []
    with _pytest.raises(TypeError, match="pickled"):
        with TorchWriter(encoders=1) as w:
            w.save(str(tmp_path / "b.jpg"), np.zeros((8, 8, 3), np.uint8),
                   lambda im: im)
    assert multiprocessing.active_children() == []
    assert os.listdir(tmp_path) == ["a.jpg"]
