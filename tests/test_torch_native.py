"""The port's native host library (``videotgb_torch/data/native``) and
``clip_transform`` against the JAX package's.

Both bindings compile the same ``host_ops.cpp`` with the same ``g++`` flags
here, so every output must be bit-equal on seeded numpy inputs. The port's
library is built under ``build/``. ``clip_transform`` is held equal on both
of its paths, and a failed build must warn once and fall back to the numpy
path."""

import logging

import numpy as np
import pytest

from _torch_port_helpers import few_torch_threads  # noqa: F401
from videotgb_torch.data import native as TN
from videotgb_torch.data import transforms as TT
from videotgb_tpu.data import native as JN
from videotgb_tpu.data import transforms as JT
from videotgb_tpu.data.constants import CLIP_MEAN, CLIP_STD


@pytest.fixture(scope="module", autouse=True)
def _both_built():
    assert JN.available(), "the JAX package's native library did not build"
    assert TN.available(), "the port's native library did not build"


def test_the_library_is_built_under_build():
    path = TN.library_path()
    assert path.parent.name == "build" and path.exists()
    assert path.parent.parent / "videotgb_torch" == TN.SRC.parents[2]
    assert TN.SRC.read_text().split("#include", 1)[1] == \
        open(JN._SRC).read().split("#include", 1)[1]


@pytest.mark.parametrize("shape, size", [((3, 120, 160, 3), 64),
                                         ((2, 37, 53, 3), 224)])
def test_resize_normalize_is_bit_equal(shape, size):
    frames = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    got = TN.resize_normalize(frames, size, CLIP_MEAN, CLIP_STD)
    want = JN.resize_normalize(frames, size, CLIP_MEAN, CLIP_STD)
    assert got.dtype == np.float32 and got.shape == (shape[0], size, size, 3)
    np.testing.assert_array_equal(got, want)


def test_normalize_flow_and_flow_to_rgb_are_bit_equal():
    flow = (np.random.default_rng(1).standard_normal((4, 32, 48, 2))
            .astype(np.float32) * 7)
    np.testing.assert_array_equal(TN.normalize_flow(flow),
                                  JN.normalize_flow(flow))
    got = TN.flow_to_rgb(flow)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, JN.flow_to_rgb(flow))


@pytest.mark.parametrize("use_native", [True, False])
def test_clip_transform_matches_jax(use_native):
    frames = np.random.default_rng(2).integers(0, 256, (3, 90, 120, 3),
                                               np.uint8)
    got = TT.clip_transform(frames, 56, use_native=use_native)
    want = JT.clip_transform(frames, 56, use_native=use_native)
    np.testing.assert_array_equal(got, want)
    if use_native:  # the default path is the library's
        np.testing.assert_array_equal(TT.clip_transform(frames, 56), got)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def test_a_failed_build_warns_once_and_takes_the_numpy_path(
        monkeypatch, tmp_path):
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_build_error", None)
    monkeypatch.setattr(TN, "library_path", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(TN, "_build", lambda target: "g++: not found")
    frames = np.random.default_rng(3).integers(0, 256, (2, 40, 60, 3),
                                               np.uint8)
    seen = _Records()
    TN.log.addHandler(seen)
    try:
        assert not TN.available()
        got = TT.clip_transform(frames, 32)
        assert not TN.available()
    finally:
        TN.log.removeHandler(seen)
    warnings = [r.getMessage() for r in seen.records]
    assert len(warnings) == 1 and "g++: not found" in warnings[0]
    np.testing.assert_array_equal(
        got, JT.clip_transform(frames, 32, use_native=False))
