"""Host-side video ingest: frame sampling rules + OpenCV decode (the
port's copy of ``videotgb_tpu/data/video_io.py``, same indices and frames).

``sample_frames`` with uniform / random / headtail chunked sampling, the
duplicate-when-short rule, the reference's eval-time flow-frame rule,
directory-of-images readers and OpenCV decode. ``cv2`` is imported inside
the readers only, so the module imports where OpenCV is not installed; the
readers then raise ``ImportError``.
"""

from __future__ import annotations

import os
import random

import numpy as np


def sample_frames(num_frames: int, vlen: int, sampling: str = "uniform") -> list[int]:
    """Pick ``num_frames`` indices from ``vlen`` (util.py:20-34): split
    [0, vlen) into num_frames chunks; uniform takes each chunk's start,
    rand a random element, headtail random halves from first/last chunks."""
    intervals = np.linspace(0, vlen, num_frames + 1).astype(int)
    ranges = [(intervals[i], intervals[i + 1]) for i in range(num_frames)]
    if sampling == "uniform":
        return [r[0] for r in ranges]
    if sampling == "rand":
        return [random.randrange(r[0], max(r[1], r[0] + 1)) for r in ranges]
    if sampling == "headtail":
        half = num_frames // 2
        head = sorted(random.sample(range(vlen // 2), min(half, vlen // 2)))
        tail = sorted(random.sample(range(vlen // 2, vlen),
                                    min(num_frames - half, vlen - vlen // 2)))
        return head + tail
    raise NotImplementedError(sampling)


def duplicate_to_length(indices: list[int], minimum: int) -> list[int]:
    """Double every element until the list reaches ``minimum``
    (util.py:89-92 / LSTP_SF_blip2_module.py:303-305)."""
    while len(indices) < minimum:
        indices = [x for i in indices for x in (i, i)]
    return indices


def reference_flow_indices(total: int, native_fps: float,
                           fps: float = 2.0) -> list[int]:
    """The reference's eval-time flow-frame rule (eval/utils/
    builder_utils.py:25-45 read_videos_av): when the requested fps does not
    exceed the native rate, take every int(native_fps)-th frame — i.e. ~1
    frame per second over the WHOLE native timeline regardless of the fps
    argument — otherwise every frame."""
    step = int(native_fps)
    if fps <= native_fps and step >= 1:
        return list(range(0, total, step))
    return list(range(total))


def candidate_indices(vlen: int, num_frames: int = 32) -> list[int]:
    """Candidate-frame rule (builder_utils.py:131-139): positions into the
    flow-frame sequence — duplicate-when-short to >= num_frames, then uniform
    chunk-start sampling."""
    idx = duplicate_to_length(list(range(vlen)), num_frames)
    return [idx[i] for i in sample_frames(num_frames, len(idx))]


def read_video_timeline(
    path: str,
    max_frames: int = 64,
    fps: float = 2.0,
    size: tuple[int, int] | None = None,
) -> tuple[np.ndarray, int]:
    """Decode flow frames over the whole native timeline at ~1 fps
    (:func:`reference_flow_indices`), uniformly thinned to ``max_frames``
    when the video is longer (the training-time <=64 cap,
    videoinstruct_dataset.py:241-243).

    Returns (frames (L, H, W, 3) uint8 RGB, L) with L <= max_frames the true
    flow length; the caller pads to a duration bucket and carries L in
    flow_mask / video_length.
    """
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    native_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if total <= 0:
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
        cap.release()
        if not frames:
            raise ValueError(f"no frames decoded from {path}")
        arr = np.stack(frames)
        wanted = reference_flow_indices(len(arr), native_fps, fps)
        if len(wanted) > max_frames:
            wanted = [wanted[i] for i in sample_frames(max_frames, len(wanted))]
        return _postprocess(arr[wanted], size), len(wanted)

    wanted = reference_flow_indices(total, native_fps, fps)
    if len(wanted) > max_frames:
        wanted = [wanted[i] for i in sample_frames(max_frames, len(wanted))]
    out = _grab_indices(cap, wanted, path)
    return _postprocess(out, size), len(wanted)


def _grab_indices(cap, wanted: list[int], path: str) -> np.ndarray:
    """Sequential grab()-skip decode of ``wanted`` frame indices (BGR)."""
    unique = sorted(set(wanted))
    grabbed: dict[int, np.ndarray] = {}
    pos = 0
    for target in unique:
        while pos < target:
            if not cap.grab():
                break
            pos += 1
        ok, frame = cap.read()
        pos += 1
        if not ok:
            break
        grabbed[target] = frame
    cap.release()
    if not grabbed:
        raise ValueError(f"no frames decoded from {path}")
    last = max(grabbed)
    return np.stack([grabbed.get(i, grabbed[min(i, last)]) for i in wanted])


def read_video_cv2(
    path: str,
    num_frames: int | None = None,
    sampling: str = "uniform",
    fps: float | None = None,
    size: tuple[int, int] | None = None,
) -> tuple[np.ndarray, float]:
    """Decode a video -> (frames (T, H, W, 3) uint8 RGB, native_fps).

    num_frames: sample that many (duplicating when short); fps: instead
    decode at ~fps frames/sec over the whole timeline (the flow-frame path,
    eval/utils/builder_utils.py:25-45); size: resize at decode time (cheaper
    than a second pass).
    """
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    native_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if total <= 0:
        # some containers misreport; decode everything
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
        cap.release()
        if not frames:
            raise ValueError(f"no frames decoded from {path}")
        arr = np.stack(frames)
        total = len(arr)
        wanted = _wanted_indices(total, num_frames, fps, native_fps, sampling)
        out = arr[wanted]
        return _postprocess(out, size), native_fps

    wanted = _wanted_indices(total, num_frames, fps, native_fps, sampling)
    # sequential scan with grab() (header-only skip) beats per-frame seeking:
    # cap.set() seeks re-decode from the previous keyframe every time
    out = _grab_indices(cap, wanted, path)
    return _postprocess(out, size), native_fps


def _wanted_indices(total, num_frames, fps, native_fps, sampling):
    if fps is not None:
        step = max(int(round(native_fps / fps)), 1)
        idx = list(range(0, total, step))
        return duplicate_to_length(idx, 1)
    assert num_frames is not None
    if total >= num_frames:
        return sample_frames(num_frames, total, sampling)
    idx = duplicate_to_length(list(range(total)), num_frames)
    return [idx[i] for i in sample_frames(num_frames, len(idx), sampling)]


def _postprocess(frames_bgr: np.ndarray, size) -> np.ndarray:
    """BGR (T,H,W,3) -> contiguous RGB, resized to ``size`` if it differs.

    Per-frame cv2.cvtColor into a preallocated output (a ``[..., ::-1]``
    view would force a strided copy, and cv2 copies again to resize from a
    negative-stride view); same-size resizes are skipped."""
    import cv2

    t, h, w, _ = frames_bgr.shape
    nh, nw = (h, w) if size is None else size
    out = np.empty((t, nh, nw, 3), np.uint8)
    for i in range(t):
        if (nh, nw) == (h, w):
            cv2.cvtColor(frames_bgr[i], cv2.COLOR_BGR2RGB, dst=out[i])
        else:
            cv2.resize(cv2.cvtColor(frames_bgr[i], cv2.COLOR_BGR2RGB),
                       (nw, nh), dst=out[i], interpolation=cv2.INTER_LINEAR)
    return out


def read_frames_dir(
    directory: str, num_frames: int, sampling: str = "uniform",
    extensions: tuple[str, ...] = (".jpg", ".jpeg", ".png"),
) -> np.ndarray:
    """Read a directory of per-frame images (util.py:37-71)."""
    import cv2

    names = sorted(
        f for f in os.listdir(directory) if f.lower().endswith(extensions)
    )
    if not names:
        raise FileNotFoundError(f"no frames in {directory}")
    idx = _wanted_indices(len(names), num_frames, None, None, sampling)
    frames = [
        cv2.imread(os.path.join(directory, names[i]))[..., ::-1] for i in idx
    ]
    return np.stack(frames)
