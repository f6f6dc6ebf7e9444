"""Chunk-parallel container decode.

The port's copy of swiftwatcher_tpu/io/parallel_decode.py.  The reference
decodes strictly in sequence on one core (io_video.py:137-165).  A
container whose seek is frame-accurate (H.264 or MPEG-4 in MP4, MJPG AVI,
...) decodes in parallel over chunks: each of K worker threads owns a
decoder, claims contiguous frame chunks, seeks to the chunk's start (cv2's
CAP_PROP_POS_FRAMES lands on the keyframe before it and decodes forward)
and publishes frames into a bounded reorder buffer that the consumer
drains in order.

At open, probe_seek_accuracy decodes the first frames in sequence and
again by seeking; any byte difference keeps the caller on the sequential
backend.  A frame that fails to decode arrives as None, as a failed cv2
retrieve does, and the FrameSource substitutes the last good frame
(io_video.py:51-53).  cv2 and libav release the GIL while they decode, so
the workers run in parallel on the host's cores.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np


def probe_seek_accuracy(
    path, total_frames: int | None = None, n_probe: int = 12, seek_at: int = 8
) -> bool:
    """True when set(CAP_PROP_POS_FRAMES) reproduces sequential decode
    byte-for-byte on this file (keyframe-accurate containers).

    Two probe families, because a single head-of-file check passes on
    containers whose seek is only accurate near keyframe 0 (open GOP,
    irregular keyframe spacing deep in the file):

    1. HEAD: decode the first n_probe frames sequentially, then re-decode
       two of them via seek and compare bytes (seek-vs-sequential truth).
    2. DEEP (when total_frames is known): at 50% and 90% of the file, read
       the same target frame via two different seek origins (directly, and
       from several frames earlier decoding forward) — frame-accurate
       containers converge on identical bytes regardless of origin, while
       imprecise ones land on different content.  Sequentially decoding to
       a deep frame for ground truth would cost a full prefix decode; the
       origin-consistency check catches the same failure class in O(GOP).
    """
    import cv2

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        cap.release()
        return False
    seq = []
    for _ in range(n_probe):
        ok, frame = cap.read()
        seq.append(frame if ok else None)
    cap.release()
    if seek_at >= len(seq) or seq[seek_at] is None or seq[0] is None:
        return False

    def _read_at(cap, pos):
        cap.set(cv2.CAP_PROP_POS_FRAMES, pos)
        ok, frame = cap.read()
        return frame if ok else None

    cap = cv2.VideoCapture(str(path))
    try:
        for probe_pos in {seek_at, max(seek_at // 2, 1)}:
            via_seek = _read_at(cap, probe_pos)
            if via_seek is None or not np.array_equal(seq[probe_pos], via_seek):
                return False
        if total_frames and total_frames > 4 * n_probe:
            back = 7
            for frac in (0.5, 0.9):
                tgt = min(int(total_frames * frac), total_frames - 1)
                direct = _read_at(cap, tgt)
                if direct is None:
                    return False
                cap.set(cv2.CAP_PROP_POS_FRAMES, tgt - back)
                stepped = None
                for _ in range(back + 1):
                    ok, stepped = cap.read()
                    if not ok:
                        return False
                if not np.array_equal(direct, stepped):
                    return False
        return True
    finally:
        cap.release()


class _Cv2Worker:
    """Per-worker cv2 handle: full-frame BGR decode (the default mode)."""

    def __init__(self, path):
        import cv2

        self._cap = cv2.VideoCapture(path)
        self._cv2 = cv2

    def seek(self, pos: int) -> bool:
        self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, pos)
        return True

    def read(self):
        ok, frame = self._cap.read()
        return frame if ok else None

    def close(self):
        self._cap.release()


class _AvGrayWorker:
    """Per-worker native libav handle decoding straight to the grayscale
    chimney crop (avpump.cpp swt_av_read_gray_crop): converts only the
    crop's rows, emits (ch, cw) uint8 — per-core faster than full-frame
    cv2 AND already in the pipeline's input form.  Callers must have
    probe-gated both the keyframe seek (probe_native_seek) and the crop
    conversion (probe_gray_crop_parity) before engaging this mode."""

    def __init__(self, path, crop_region):
        from .native_av import AVReader

        self._rd = AVReader.open(path)
        if self._rd is None:
            raise RuntimeError(f"{path}: native libav open failed in worker")
        self._crop = crop_region

    def seek(self, pos: int) -> bool:
        return self._rd.seek(pos)

    def read(self):
        return self._rd.read_gray_crop(self._crop)

    def close(self):
        self._rd.close()


def gray_crop_worker_factory(crop_region):
    """Worker factory for ParallelDecoder that decodes straight to the
    grayscale chimney crop (engage only after probe_native_seek AND
    probe_gray_crop_parity pass on the file/geometry)."""
    return lambda path: _AvGrayWorker(path, crop_region)


class ParallelDecoder:
    """Ordered frame stream decoded by chunk-claiming worker threads."""

    def __init__(
        self,
        path,
        total_frames: int,
        n_workers: int = 4,
        chunk: int = 16,
        max_ahead: int = 64,
        start: int = 0,
        worker_factory=None,
        boundaries=None,
    ):
        """`boundaries`: optional ascending keyframe frame-numbers (from
        AVReader.keyframes).  Chunks then span keyframe-aligned ranges (each
        >= `chunk` frames), so a worker's seek lands exactly on its chunk
        start instead of decoding forward through up to a whole GOP of
        discarded frames per chunk — on real surveillance footage (GOP
        ~250) fixed 16-frame chunks would redundantly decode ~15x.  Frames
        are published incrementally with backpressure, so long chunks do
        not blow the `max_ahead` memory bound."""
        self.path = str(path)
        self.total = total_frames
        self._worker_factory = worker_factory or _Cv2Worker
        self.chunk = max(chunk, 1)
        self.max_ahead = max(max_ahead, 2 * self.chunk)
        # chunk-start table: bounds[c] .. bounds[c+1] is chunk c
        starts = [0]
        if boundaries is not None:
            for k in boundaries:
                k = int(k)
                if k - starts[-1] >= self.chunk and k < total_frames:
                    starts.append(k)
        else:
            starts = list(range(0, max(total_frames, 1), self.chunk))
        self._bounds = np.asarray(starts + [total_frames], np.int64)
        self._lock = threading.Lock()
        self._have = threading.Condition(self._lock)
        self._need = threading.Condition(self._lock)
        self._frames: dict[int, Optional[np.ndarray]] = {}
        self._next_chunk = self._chunk_of(start)
        self._consumed = start          # lowest frame number not yet taken
        self._gen = 0                   # bumped by restart(): stale workers
        self._stop = False              # abandon their chunk mid-decode
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(max(n_workers, 1))
        ]
        for t in self._threads:
            t.start()

    def _chunk_of(self, frame_number: int) -> int:
        return max(
            int(np.searchsorted(self._bounds, frame_number, "right")) - 1, 0
        )

    # -- worker side --------------------------------------------------------
    def _claim(self):
        with self._lock:
            while True:
                if self._stop:
                    return None
                c = self._next_chunk
                # Past the end: PARK rather than exit — a restart() (e.g.
                # checkpoint resume after a full pass) re-aims the chunk
                # counter and needs live workers to serve it.
                if c + 1 < len(self._bounds):
                    lo = int(self._bounds[c])
                    # backpressure: don't claim further than max_ahead
                    # frames past the consumer (with incremental publishing
                    # below, the buffered-frame bound is ~max_ahead even
                    # for GOP-long chunks)
                    if lo - self._consumed < self.max_ahead:
                        self._next_chunk += 1
                        return c, self._gen
                self._need.wait()

    def _worker(self):
        try:
            rd = self._worker_factory(self.path)
        except Exception:
            # a reader that fails to construct must not strand the chunks
            # this thread claims: keep claiming and publish decode failures
            # (None frames -> the FrameSource's last-good substitution)
            rd = None
        try:
            pos = -1                     # reader's current frame cursor
            while True:
                claim = self._claim()
                if claim is None:
                    return
                c, gen = claim
                lo = int(self._bounds[c])
                hi = int(self._bounds[c + 1])
                seek_ok = rd is not None and (pos == lo or rd.seek(lo))
                # A failed read does NOT advance ffmpeg's cursor: the rest
                # of the chunk is published as decode failures (frames read
                # after a non-advancing failure would be silently shifted)
                # and the next chunk re-seeks.
                failed = not seek_ok
                abandoned = False
                for fn in range(lo, hi):
                    frame = rd.read() if not failed else None
                    failed = failed or frame is None
                    with self._lock:
                        # stale generation: a restart() moved consumption —
                        # abandon the chunk instead of publishing frames
                        # nobody will pop
                        if self._gen != gen or self._stop:
                            abandoned = True
                            break
                        # frames behind the consumer window can never be
                        # returned (get() refuses fn < consumed-1): decode
                        # past them but don't store — a restart() into the
                        # middle of a GOP-long chunk would otherwise strand
                        # the whole keyframe->restart prefix (full-BGR
                        # frames!) in the buffer for the life of the stream
                        if fn >= self._consumed - 1:
                            self._frames[fn] = frame
                            self._have.notify_all()
                        # in-chunk backpressure: bound buffered frames even
                        # when the chunk is a whole GOP
                        while (
                            fn + 1 < hi
                            and fn + 1 - self._consumed >= self.max_ahead
                            and self._gen == gen
                            and not self._stop
                        ):
                            self._need.wait()
                pos = -1 if (failed or abandoned) else hi
        finally:
            if rd is not None:
                rd.close()

    # -- consumer side ------------------------------------------------------
    def get(self, frame_number: int, timeout: float = 300.0):
        """The decoded frame (or None on decode failure), in any order
        within the streaming window; blocks until the worker delivers."""
        with self._lock:
            while frame_number not in self._frames:
                if self._stop:
                    return None
                if frame_number < self._consumed - 1 or frame_number >= self.total:
                    return None          # behind the window or past the end
                if not self._have.wait(timeout):
                    raise TimeoutError(
                        f"parallel decode stalled at frame {frame_number} "
                        f"of {self.path}"
                    )
            frame = self._frames.pop(frame_number)
            if frame_number >= self._consumed:
                self._consumed = frame_number + 1
                self._need.notify_all()
            return frame

    def restart(self, frame_number: int):
        """Reposition the stream (checkpoint resume): drop buffered frames,
        re-aim the chunk counter, and invalidate in-flight chunks (workers
        check the generation and abandon mid-decode)."""
        with self._lock:
            self._frames.clear()
            self._gen += 1
            self._next_chunk = self._chunk_of(frame_number)
            self._consumed = frame_number
            self._need.notify_all()

    def close(self):
        with self._lock:
            self._stop = True
            self._need.notify_all()
            self._have.notify_all()
        for t in self._threads:
            t.join(timeout=5)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
