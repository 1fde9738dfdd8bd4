"""Profile the host video decode of the QA path and A/B its candidate
savings.

The counterpart of the JAX package's ``tools/decodeprobe.py``, with the
port's own copies of ``bench.py``'s ``make_synthetic_video`` and
``decode_clip_uint8``. It writes a synthetic 30 fps mp4 and times, per clip
(median over ``--clips`` runs after one warm run), at 32 frames of 224^2:

  current     read_video_cv2 grab-skip at max(image, flow) + 2 resizes
  readonly    cv2 open + grab/retrieve only (the codec's floor)
  direct224   decode with cv2.resize to 224 at retrieve time, INTER_LINEAR
              and INTER_AREA
  read only   read_video_cv2 without the resizes (the resize delta)

Host times move from run to run; only ratios within one run matter.
``cv2`` is imported inside the functions.

    python -m videotgb_torch.tools.decodeprobe [--clips 20] [--res 256]
"""

from __future__ import annotations

import argparse
import os
import statistics
import tempfile
import time

import numpy as np


def make_synthetic_video(path: str, num_frames: int = 96,
                         size: int = 224) -> None:
    """A 30 fps mp4v clip: one random frame rolled 3 pixels a frame plus
    noise, from seed 0."""
    import cv2

    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(path, fourcc, 30.0, (size, size))
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (size, size, 3), np.uint8)
    for t in range(num_frames):
        frame = np.roll(base, shift=3 * t, axis=1)
        noise = rng.integers(0, 20, (size, size, 3), np.uint8)
        writer.write(cv2.add(frame, noise))
    writer.release()


def decode_clip_uint8(path: str, num_frames: int, flow_frames: int,
                      image: int, flow_size: int):
    """(frames (num_frames, image, image, 3), flow frames (flow_frames,
    flow_size, flow_size, 3)), uint8: normalization happens on the device."""
    from videotgb_torch.data.transforms import resize_video
    from videotgb_torch.data.video_io import read_video_cv2, sample_frames

    frames, _ = read_video_cv2(path, num_frames=num_frames,
                               size=(max(image, flow_size),) * 2)
    flow_ids = sample_frames(flow_frames, num_frames)
    flow_raw = resize_video(frames[flow_ids], (flow_size, flow_size))
    return (np.ascontiguousarray(resize_video(frames, (image, image))),
            np.ascontiguousarray(flow_raw))


def timeit(fn, n, *args) -> float:
    """Median ms of ``fn(*args)`` over ``n`` runs after one warm run."""
    fn(*args)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(*args)
        ts.append((time.perf_counter() - t0) * 1000)
    return statistics.median(ts)


def _retrieve(path, num_frames, resize=None):
    """The wanted frames of a clip by grab/retrieve, each resized by
    ``resize`` (a function of a BGR frame) when given."""
    import cv2

    from videotgb_torch.data.video_io import sample_frames

    cap = cv2.VideoCapture(path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    wanted = sample_frames(num_frames, max(total, 1))
    out, pos = [], 0
    for t in sorted(set(wanted)):
        while pos <= t:
            if not cap.grab():
                break
            pos += 1
        ok, f = cap.retrieve()
        if ok:
            out.append(f if resize is None else resize(f))
    cap.release()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clips", type=int, default=20)
    ap.add_argument("--res", type=int, default=256, help="source video res")
    ap.add_argument("--frames", type=int, default=90, help="source frames")
    ap.add_argument("--num_frames", type=int, default=32)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--flow", type=int, default=224)
    args = ap.parse_args(argv)

    import cv2

    fd, path = tempfile.mkstemp(suffix=".mp4")
    os.close(fd)
    out = {}
    try:
        make_synthetic_video(path, num_frames=args.frames, size=args.res)
        n = args.clips
        out["current"] = timeit(lambda: decode_clip_uint8(
            path, args.num_frames, 5, args.image, args.flow), n)
        print(f"current              {out['current']:8.1f} ms/clip")
        out["readonly"] = timeit(lambda: _retrieve(path, args.num_frames), n)
        print(f"readonly (floor)     {out['readonly']:8.1f} ms/clip")
        for name, interp in (("linear", cv2.INTER_LINEAR),
                             ("area", cv2.INTER_AREA)):
            def resize(f, interp=interp):
                return cv2.resize(f[:, :, ::-1], (args.image, args.image),
                                  interpolation=interp)
            out[f"direct224_{name}"] = timeit(lambda: np.stack(
                _retrieve(path, args.num_frames, resize)), n)
            print(f"direct224 {name:10s} {out[f'direct224_{name}']:8.1f} "
                  "ms/clip")

        from videotgb_torch.data.video_io import read_video_cv2

        out["read_video_cv2"] = timeit(lambda: read_video_cv2(
            path, num_frames=args.num_frames,
            size=(max(args.image, args.flow),) * 2), n)
        print(f"read_video_cv2 only  {out['read_video_cv2']:8.1f} ms/clip  "
              f"(resize delta {out['current'] - out['read_video_cv2']:.1f})")
    finally:
        os.remove(path)
    return out


if __name__ == "__main__":
    main()
