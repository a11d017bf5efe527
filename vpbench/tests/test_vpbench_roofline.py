"""The synthesis work count of ``synthesis_roofline_share``, against
values worked out by hand."""

import math
import pathlib

import pytest

from vpbench import pool, roofline

MUSIC = pathlib.Path(__file__).resolve().parents[1] / "data" / "music"


def test_dct_iv_count():
    # m = 128: 2.5 * 128 * log2(64) + 6 * 128 = 1920 + 768
    assert roofline.dct_iv_flops(128) == 2688
    assert roofline.dct_iv_flops(1024) == 2.5 * 1024 * 9 + 6 * 1024


def test_channel_counts():
    class F0:
        floor_type, order, bark_map_size = 0, 4, 64

    class F1:
        floor_type = 1

    # IMDCT 2688, window and overlap 384, floor product 128, LSP curve
    # 2 * 4 * min(128, 64) = 512
    assert roofline.channel_flops(128, F0) == 2688 + 384 + 128 + 512
    # floor1 curve: one step a line
    assert roofline.channel_flops(1024, F1) == (
        roofline.dct_iv_flops(1024) + 4 * 1024 + 1024)


def test_small_chunk():
    """A music member cut to its first 4 pages: 38 short (256) and 64
    long (2048) stereo floor1 packets, one coupling step. A short packet:
    2 x (2688 + 3 x 128 + 128 + 128) + 2 x 128 = 6912; a long one:
    2 x (23040 + 6144 + 3 x 1024 + 1024 + 1024) + 2 x 1024 = 70656."""
    data = pool.cut((MUSIC / "s00.ogg").read_bytes(), 4)
    assert roofline.stream_flops(data) == 38 * 6912 + 64 * 70656


def test_least_time():
    assert roofline.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert roofline.least_seconds(1.0, 67e12 * 2) == pytest.approx(2.0)
    assert math.isclose(roofline.PEAK_BYTES_S / roofline.PEAK_FLOPS_S,
                        3.35 / 67)
